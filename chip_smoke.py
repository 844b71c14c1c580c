#!/usr/bin/env python3
"""Smoke test of the PyTorch port on one NVIDIA H100.

Drives ``mxnet_tpu_torch``'s paths on the card, through the entry
points a user calls: paged decode serving of a GPT-2-small-width
``TransformerDecoderLM`` (random fp32 weights from seed 0);
``ModelServer.predict`` on a ``BERTClassifier`` over ``bert_24_1024_16``,
from the module and from its exported artifacts, float and quantized
(``load_artifact``),
and ``ModelServer.generate`` on that LM, each also through two replicas
sharing the card (``ServingConfig(replicas=2)``), and both replaying a
seeded multi-tenant trace behind tenant tiers and SLO autoscalers;
``ShardedTrainer.step`` on
``BERTForPretrain`` over ``bert_24_1024_16`` with ``use_flash=True``;
and ``TrainingSupervisor.run`` over that step with ``CheckpointManager``
checkpoints, through injected faults and a SIGTERM.
Phases, each printed as one JSON line:

1. ``device``  — card name, device count, power limit;
2. ``build``   — compile the five CUDA kernels (``nvcc``, ``sm_90a``,
   one process per source, all started together; with
   ``MXNET_COMPILE_CACHE_DIR`` set a library the persistent cache holds
   is copied from it instead), with each compiled
   kernel's registers and spills from ptxas; the bf16 forward's
   tensor-core kernel must neither spill nor have its ``wgmma``
   serialised; the fp32 B1/B2/B3 kernels must not spill at head dim 64,
   and every instantiation's SASS must hold TF32 tensor-core products
   (``HMMA.1688.F32.TF32``: fp32 B1-B3 run each product as 3xTF32 on
   ``mma.sync``, ``build_sass`` lines); then ``build_cache`` — two
   builds into empty directories with one new compile cache set: the
   first compiles and stores every library, the second must copy every
   one from the cache, byte for byte, without ``nvcc``;
3. ``kernels`` — B4/B5 (paged decode / verify attention) against their
   plain PyTorch versions at the serving shapes, fp32 and bf16 (B4 also
   at the profile phase's decode contexts and against its split mirror,
   and three interleaved calls on each of two shapes must repeat bit
   for bit; B5 also at the served prefix-hit shape: one slot, 256
   cached tokens, a 37-token tail at the engine's width bucket), with
   their device times, the plain versions' times, one PyTorch library
   call's time, the roofline bound and both kernels' split plans; then
   ``head_dims`` — both kernels at every compiled head dim, small
   shapes, each over a context its plan splits three ways or more (B5
   with windows across its row tiles);
4. ``flash_kernels`` — B1/B2/B3 (flash-attention forward, dQ, dK/dV)
   against their plain versions at BERT-large's shapes (the training
   batch, lengths 0/1/37/512, causal, causal + window 128, Lq != Lk,
   head dims 16, 32 and 128 beside 64, L = 2048, and the ``predict``
   phase's bucket-16 batch: BH = 256, L = 128, two padding rows of
   length 0), fp32 and bf16, with
   times, bounds and the ``scaled_dot_product_attention`` yardstick
   (forward; backward); fp32 O is also held to 1e-5 of its max, LSE to
   1e-5 and the gradients to 1e-5 of their max (3xTF32 is
   fp32-accurate); two bf16 B1 calls, and two fp32 B1, B2 and B3 calls,
   on the training batch must be bitwise equal; head dims 24 and 256
   must be refused.  Bounds take 165 TFLOP/s for fp32 (3xTF32, a
   third of the TF32 rate) and 989 for bf16;
5. ``parity``  — ``paged_prefill`` + 32 ``paged_decode_step``s, a
   width-37 ``paged_verify`` and the same window through
   ``paged_verify_batch`` against the dense full forward, and the launch
   counters rising by ``num_layers`` per call;
6. ``serve``   — 8 threads calling ``DecodeEngine.generate`` at once,
   then 4 requests sharing a 256-token prefix (prefix-cache hits run
   the verify kernel), through the adapter's CUDA graphs, all captured
   when the engine binds the adapter (``torch.cuda.memory_allocated``
   before and after the adapter's ``warm()``, and the graph pool's
   live bytes); the B4/B5 counters are zeroed
   just before the engine is built and read just after the waves (they
   count the captures' eager warm-up launches); then the same prompts
   through an eager (``graphs=False``) engine, its tokens compared
   (reported);
6b. ``predict`` — ``ModelServer`` (4 workers, ``max_batch_size`` 16)
   over ``ModelRepository.add_block`` of a ``BERTClassifier`` on
   ``bert_24_1024_16`` (fp32, ``use_flash=True``, seed 0, depth not
   cut) at L = 128: one CUDA graph per bucket {1, 2, 4, 8, 16}, each
   capturing 24 B1 launches, built by ``prewarm`` (capture seconds,
   memory, the pools' bytes); 8 clients x 12 requests of 1-5 rows and
   valid lengths 16-128 (``RandomState(0)``), every response within
   1e-4 of the traffic's max|logit| of the eager forward on the request
   alone and of the dense (``use_flash=False``) path; fewer batches than
   requests, at most 5 programs, no bucket built after prewarm;
   requests/s, rows/s, latency p50/p99, mean bucket occupancy.  Then
   the traffic again with version 2 (seed 1) registered, prewarmed and
   swapped in under load: each response matches the version that
   admitted it; ``unload`` of version 1 must free at least its
   snapshot's bytes.  Then ``ModelServer.generate`` (``add_decoder`` on
   the LM) on ``serve``'s waves from as many threads: its tokens must
   equal ``serve``'s.  The B1/B4/B5 counters are zeroed before the
   server is built and read after ``generate`` (the captures' eager
   warm-ups);
6b′. ``replicas`` — ``predict``'s classifier (seed 0) registered once
   and served by a ``replicas=1`` and a ``replicas=2`` ``ModelServer``
   (``predict``'s config): each replica captures its own five bucket
   graphs over the one snapshot at ``prewarm`` (capture seconds and pool
   bytes per replica); ``predict``'s traffic through both in turns (1,
   2, 2, 1: requests/s, p50, p99), every response within 1e-4 of
   max|logit| of the eager forward, both replicas serving, no bucket
   built after prewarm; a batch failed over between replicas against
   the ``replicas=1`` program on the same inputs (1e-5 of max|logit|,
   bitwise equality reported); under traffic, r0's dispatch failing
   twice (failovers, every response in the gate), r0's heartbeat stalled
   (UNHEALTHY within the window, r1 alone serving), then cleared (r0
   captures its graphs again while r1 replays, and serves again), and
   ``restart("r1")``; a replica placed on another card than the weights'
   must be refused with ``MXNetError``.  Then ``serve``'s configuration
   with ``replicas=2`` through ``ModelServer.generate``: each replica an
   adapter clone sharing the LM's weights (0 bytes copied) with its own
   KV pool and graphs, ``serve``'s waves giving ``serve``'s tokens, a
   decode step failing on r0 mid-generation quarantining the sequence
   and failing it over to r1 with the same tokens, no page leaked.  The
   B1/B4/B5 counters are zeroed before the servers are built and read
   after the decode failover (24 B1 per predict capture, ``num_layers``
   B4 per decode replica); every server stops at the end of the phase;
6b″. ``traffic`` — a seeded multi-tenant burst trace (8 s, 14
   requests/s, lognormal arrivals, a 10x burst of 2 s at 0.45 of the
   trace, 6 tenants over gold / silver / free, 35% generate rows)
   predict rows of 1-12 rows, recorded to JSONL and replayed from the
   file by 32 closed-loop clients honouring retry-after, twice, each on a fresh
   ``ModelServer(replicas=2, tenant_tiers="gold=100,silver=10/8/12,
   free=1/2/4")`` holding ``predict``'s classifier ("bert") and the
   serving LM ("gpt2", prefix cache on), with one ``Autoscaler`` a model
   (SLOs: ``predict``'s p99 latency and a queue of one full bucket,
   ``serve``'s p99 TTFT): ``frozen`` (ceiling 2 replicas) and ``scaled``
   (ceiling 4), r0's heartbeat stalled in each set as the burst lands
   in both.  The replay must
   return with every non-ok status shed or deadline; the scaled run must
   add a bert replica, HEALTHY with its five graphs, and remove one in
   the quiet tail after the trace, after which the reserved memory is
   within one replica's pools of its value before the run; free's shed
   rate at least gold's, no pressure shed of gold; 16 ok bert responses
   of each run within 1e-4 of max|logit| of the eager classifier and 4
   ok generations (no shared prefix) equal to an eager engine's tokens.
   Reported: attainment, goodput, TTFT p50/p99, latency p99, shed rates
   per tier, the autoscalers' decision ledgers and each scale-up's
   prewarm.  The B1/B4/B5 counters are zeroed before the first server
   and read after the second run;
6c. ``artifact`` — the same seed-0 classifier exported on the card by
   ``deploy.export_stablehlo(dynamic_batch=True)`` (a ``torch.export``
   program, B1 as the operator ``mxnet_tpu_torch::flash_attention_fwd``),
   loaded by ``ModelRepository.load_artifact`` into a fresh repository
   and served by a fresh ``ModelServer`` with ``predict``'s config:
   ``prewarm`` captures the five buckets (one loaded module shared by
   all), then ``predict``'s traffic; the served graph holds 24 B1 nodes,
   every response is within 1e-4 of max|logit| of the exporting
   module's eager forward (bitwise equality reported), 5 programs, none
   built after prewarm, fewer batches than requests, and the B1 counter
   (zeroed just before the load, read after the traffic) is 24 per
   capture; export, load and capture seconds, artifact bytes,
   requests/s, rows/s, latency p50/p99.  Then a small classifier (2
   layers, head dim 64) exported on the CPU and loaded on the card must
   name no other device and match its CUDA twin within 1e-5 of
   max|logit|; and the host time of one eager B1 call through the
   wrapper and through its operator.  The server and the files are
   freed before training;
6d. ``artifact_quant`` — the same seed-0 classifier exported on the
   card as float32 and with ``quantize="int8"`` and ``"fp8"`` (manifest
   v4: 101 weights of the mode's dtype, a 64-hex digest, calibrated on
   the first 8 rows of ``predict``'s traffic), each quantized artifact
   below a third of the float one's bytes; each artifact loaded by
   ``load_artifact`` into a fresh repository and served by a fresh
   ``ModelServer`` with ``predict``'s config and traffic: 24 B1 nodes
   in the served graph, 120 B1 wrapper launches (5 captures), 5
   programs, none built after prewarm, fewer batches than requests,
   every response within 1e-4 of max|logit| of the loaded program's
   eager call on the request alone, and each quantized response within
   10 x the manifest's ``max_abs_err`` + 1e-3 of the float module's
   eager logits; memory around prewarm and each graph pool's bytes,
   bucket-1 and bucket-16 replay device ms (CUDA events).  Then the
   int8 artifact hot-swapped in as version 2 over the float one under
   traffic (each response matches the version that admitted it), and a
   small classifier exported int8 and fp8 on the CPU and loaded on the
   card against its twin exported on the card (payloads and scales
   equal, logits within 1e-5 of max|logit|), and ``quantize``'s
   per-tensor and blockwise payloads and scales on the card bit for bit
   against its CPU run.  The files stay on disk for
   ``artifact_quant_trace``;
7. ``train_parity`` — BERT-large fp32: the flash path's loss and every
   parameter gradient against the dense additive-mask path on the same
   weights and batch (B = 8, L = 512);
8. ``train``   — adamw ``ShardedTrainer`` steps, fp32 then bf16, eager
   (``graphs=False``) and as one CUDA graph per batch signature (the
   default) from the same weights: 2 warm-up + 10 timed steps each, in
   turns; ms/step, samples/s, memory, the step's FLOPs counted from
   the step (``ShardedTrainer.step_flops``) beside the old 6NBL rule,
   TFLOP/s and MFU; the B1-B3 counters are zeroed just before each step
   and read just after it, and rise by 24 (one per layer) on each eager
   step and on a graph's first (eager, captured) step, by 0 on a
   replay; their sums are reported by dtype and mode;
8b. ``durability`` — ``TrainingSupervisor.run`` over the captured bf16
   step of BERT-large's widths at ``DURABILITY_LAYERS`` (4) layers
   (dropout 0, adamw lr 1e-4), batches
   from an ``io.NDArrayIter`` over 48 rows made like the training batch,
   12 steps, a verified ``CheckpointManager`` checkpoint every 4
   (``max_to_keep`` 2, async writes, in a ``tempfile.mkdtemp()``
   directory whose filesystem and free bytes are printed); once
   uninterrupted, once from the same seed and warm-up step with a step
   deadline (20 graph steps of ``train``'s, at least 1 s) under a fault
   plan: a killed step, a corrupted checkpoint met by the restore that
   follows (fallback to the previous verified step) and a step stalled
   past the deadline.  Gates: 2 restarts, 1 timeout, 1 fallback, the
   uninterrupted run's 12 losses within 1e-3 relative (bitwise equality
   reported), a save / step / restore round trip giving back every
   tensor the save read bit for bit, and the stalled step, released
   after the run, neither replaying nor changing the state.  Readings:
   save seconds (snapshot, write, hash, barrier), restore seconds
   (verify, read, copy in), restore seconds of each restart, bytes of a
   step directory and of the pinned staging buffers, and the graph
   step's ms with and without the watchdog, in turns.  The B1-B3
   counters are zeroed before the two trainers are built and read after
   the faulted run (each trainer's capture: 24 each);
   ``durability_rng`` — a two-layer fp32 BERT at BERT-large widths with
   dropout 0.1, graphs: step 2 restored in place with the RNG state of
   its checkpoint's extra payload must repeat step 3's loss bit for bit,
   and without that state must not;
   ``durability_signal`` — three child processes (``--durability-child``;
   two layers, bf16, a checkpoint every step; kernels from the
   persistent compile cache of ``build_cache``, no ``nvcc``): one
   uninterrupted, one sent SIGTERM between steps once it reports step
   5 (its ``save_on_signal`` handler prints the step it saves; it must
   exit by the signal with ``LATEST`` at that step and the step's
   manifest verifying), one that auto-resumes from that directory: its
   10 losses within 1e-3 relative of the uninterrupted child's;

The phases from here on run ``torch.profiler`` (``_profiled``: each
trace window padded by ``TRACE_PAD_S`` of idle time at both ends), whose
device tracing slows every later launch.  A trace that counts graph
replays first launches each graph once inside the trace and does not
count those records (the warm-up of ``_profiled``: a trace's first
launch can lose its first kernels' records); the ``trace_launches``
line gives each such trace's device records per launch:

9. ``profile`` / ``profile_train`` — one decode step, replaying its
   CUDA graph and launching from Python side by side, and the bf16
   training step, eager and replayed, traced with ``torch.profiler``
   (device time by kernel family, kernels and host calls per step, the
   device idle share against the untraced step time, taken before the
   trace); the bf16 training step must run 24 kernel records each of
   B1-B3 per step in both modes, and its forward, dQ and dK/dV families
   must come from the tensor-core (``wgmma``) kernels alone;
   ``train_graphs`` — the training step's graph against the eager step
   over 3 steps from the same weights (fp32 losses within 1e-6
   relative and parameters within 1e-5 of max|w|, bf16 losses within
   1e-3; bitwise equality reported), three traced replays holding 24
   kernel records each of B1-B3 per replay with no wrapper count, and
   dropout 0.1
   drawing other masks on two replays from one restored state (0.0:
   the same loss);
   ``durability_trace`` — three more supervised steps of
   ``durability``'s faulted run (and its closing checkpoint) traced:
   24 kernel records each of B1-B3 per replay, no wrapper count;
10. ``graphs`` — ``PagedLMAdapter``'s CUDA graphs (one per (family,
   shape) signature) against ``graphs=False`` on the same inputs at
   GPT-2-small widths: prefill at bucket 512, the decode step at the
   profile phase's batch, verify at width 64 and verify_batch (2, 64),
   each held to 1e-5 of max|logit| (bitwise equality reported); a
   family's first call counts ``num_layers`` eager launches of its
   kernel, a replay none; three interleaved replays of two signatures
   repeat bit for bit; traced replays hold ``num_layers`` B4 / B5
   kernels each (``torch.profiler`` kernel records); ``compiled ==
   programs``; ``refresh()`` with new weights serves a fresh adapter's
   logits;
11. ``serve_trace`` — ``serve``'s traffic on a new graphs engine under
   ``torch.profiler``: B4/B5 kernel records must equal ``num_layers``
   per decode / verify replay, and the wrappers count nothing;
12. ``predict_trace`` — ``predict``'s traffic again on version 2 under
   ``torch.profiler``: exactly 24 B1 kernel records per replayed batch,
   no wrapper count, the device idle share against the untraced
   window's wall time; and 10 calls of the bucket-16 program traced for
   its device time;
13. ``artifact_trace`` — the artifact exported and loaded again, its
   bucket-16 program built and 10 replays traced: exactly 24 B1 kernel
   records per replay and no wrapper count, the logits within 1e-4 of
   max|logit| of the exporting module's eager forward;
14. ``artifact_quant_trace`` — ``artifact_quant``'s float, int8 and fp8
   artifacts loaded again, bucket 16 built for each and 10 replays
   traced: exactly 24 B1 kernel records per replay and no wrapper
   count, device ms per replay by kernel family, and the
   dequantization's ms per replay against the float program;
15. ``replicas_trace`` — each ``replicas`` replica's bucket-16 graph
   (kept after its server stopped), 10 replays traced: exactly 24 B1
   kernel records per replay and no wrapper count;
16. ``traffic_trace`` — the trace's first 2 s replayed under
   ``torch.profiler`` on a server with the replica count ``traffic``'s
   scaled run reached (no autoscaler, a 60 s heartbeat window): exactly
   24 B1 records a bucket replay, ``num_layers`` B4 a decode replay and
   ``num_layers`` B5 a verify replay, and no wrapper count.

After ``train_graphs`` (the parent's trainers freed), multi-rank
training: ranks are this script (``--dist-worker``) started by
``mxnet_tpu_torch.tools.launch``, loading the kernel libraries the
parent built (no ``nvcc``); a rank's failure fails the script.

17. ``dist_nccl`` — one NCCL rank (world 1): ``dist.initialize``,
   ``barrier``, ``allreduce_host`` / ``broadcast_host``, then
   BERT-large bf16 (seed 0, the training batch) 3 steps through a
   graphs ``ShardedTrainer`` on ``make_mesh()`` over the group, its
   float32 bucket all-reduces issued in the eager step and the capture
   (``collectives``), against the one-card graphs trainer: losses bit
   for bit; a traced replay of each (24 B1-B3 records, the grouped
   graph's extra bucket-pass kernels; NCCL launches no kernel for an
   in-place all-reduce of one rank);
18. ``dist_tp`` / ``dist_checkpoint`` / ``dist_dp_int8`` /
   ``dist_ring`` — one job of two gloo ranks sharing the card (timings
   are two ranks on one card through host memory, not a multi-GPU
   figure): BERT-large fp32 (TF32 off) at dp 1 x tp 2, 3 AdamW steps at
   lr 1e-4, B1-B3 at BH 64 (24 wrapper launches a step a rank), against
   the one-rank eager trainer (losses 1e-4 relative, gathered
   parameters atol 3e-4); a sharded checkpoint after step 2 restored
   into a fresh trainer whose step 3 is the uninterrupted one bit for
   bit (save / restore seconds); int8-compressed dp 2 in bf16 (4 rows a
   rank): first loss within 1e-4 of the uncompressed dp 2 step's,
   losses falling, wire bytes under logical and ``kvstore.wire.bytes``
   = 3 x ``wire_bytes_per_step``; sp 2 ring attention (B 1, H 16, L
   4096, D 64, causal and causal with window 512) against the dense
   masked softmax on rank 0 (out 1e-4, dQ / dK / dV 1e-3 of max), with
   the transport used; ``dist_ep``: ``gluon_moe``'s Switch-width layer
   (a Gluon block through ``ShardedTrainer``) at dp 1 x ep 2, each rank
   holding 4 of the 8 experts, batch 2, 3 AdamW steps against the
   one-rank trainer (losses 1e-4 relative, gathered parameters atol
   3e-4); then a two-rank probe of gloo's send / recv of
   a CUDA tensor (its exit code and what arrived; the port stages
   every gloo hop through host memory whatever it finds).

Then the Gluon training path (``nd``, ``autograd``, ``gluon``,
``gluon.data``, ``metric``, ``kvstore``), fp32 with TF32 off:

19. ``gluon_lenet`` — the LeNet of ``examples/mnist_gluon.py`` at its
   published widths (Conv2D 20 k5, MaxPool 2, Conv2D 50 k5, MaxPool 2,
   Dense 500, Dense 10), batch 64 of 1x28x28 from ``RandomState(0)``,
   Adam lr 1e-3, ``SoftmaxCrossEntropyLoss``, 20 steps on ``mx.gpu(0)``
   through ``autograd.record`` / ``backward`` / ``Trainer.step``: the
   losses fall, and the first 3 equal the same run on ``mx.cpu(0)``
   from the same weights (``GLUON_LENET_RTOL``); ms a step;
20. ``gluon_flash`` — one BERT-large encoder layer (units 1024, 16
   heads, FFN 4096) written as a user ``HybridBlock`` around
   ``F.flash_selfatt``, L 512, batch 8 with valid lengths below 512, a
   two-way head on position 0, 3 Adam steps: losses and the qkv
   weight's first gradient against the same layer on the host
   (``GLUON_FLASH_*``); B1 once a forward and B2, B3 once each a
   backward (the wrappers' counters); one
   ``nd.ragged_paged_attention_op`` call at ``kernels``' B4 batch
   against the host's, B4 launched once;
21. ``gluon_dist`` — two gloo ranks on the one card (this script with
   ``--gluon-worker``, started by ``mxnet_tpu_torch.tools.launch``),
   the reference's ``dist_sync`` sequence on CUDA values, then
   ``gluon_flash``'s layer by ``Trainer(..., "sgd",
   kvstore="dist_sync")`` on 4 rows a rank, rank 1 starting from other
   weights: the ranks' parameters bit for bit equal before the first
   step and after each, and within ``GLUON_DIST_*`` of the one-rank
   full-batch run; an int8-compressed push's ``kvstore.wire.bytes``
   under its ``kvstore.push.bytes`` (timings: two ranks on one card
   through host memory);
22. ``gluon_hybrid`` — ``gluon_lenet``'s LeNet and ``gluon_flash``'s
   layer hybridized (module comment above ``GLUON_HYBRID``): LeNet with
   its loss outside, 20 steps, against the eager run; 8 recorded
   micro-batch calls of it under one ``record()`` and one
   ``autograd.backward`` against the eager block's gradients
   (``GLUON_LENET_RTOL``), each instance's pool bytes, and
   ``trainer.grad_norm`` after the ``_fused_update`` step within 1e-6
   of the host's norm; the layer with its loss inside one block, 10
   Adam steps at lr 1e-4, four ways: eager, with the lazy forward
   (from step 2 the loss is lazy after ``record()``, and from step 3
   ``Trainer.step`` replays exactly one graph: forward, backward and
   update, B1-B3 one kernel record each a traced step inside it), with
   ``MXNET_DEFERRED_HYBRID_FWD=0`` (two graphs a step) and with the loss read
   before each step; the lazy runs' losses within 1e-5 relative and
   parameters within 1e-5 of their max|w| of the two-graph one, both paths'
   host split (record, backward, step), device ms, idle share and host
   calls a step; ``trainer.grad_norm`` after one more full step; and
   ``clip_global_norm`` over the layer's gradients with three
   thresholds (one program, one capture) within 1e-6 of the same torch
   ops run eagerly; then the layer's inference replay, bucketed
   lengths, the bounded cache, Dropout and BatchNorm;
23. ``gluon_mnist`` — ``examples/mnist_gluon.py``'s loop at its
   published settings (module comment above ``GLUON_MNIST``): one epoch
   of 128 steps on the card, batches and weights on ``cuda``, losses
   finite and falling, the first 3 within ``GLUON_LENET_RTOL`` of a host
   run from the same weights and batches, the epoch's accuracy above
   0.5; a second loader with 2 workers and pinned memory gives the
   first 8 batches bit for bit; seconds an epoch and the step's split
   (``next(loader)``, forward / backward / step, ``metric.update``);
   and what ``NDArray._data``'s lazy check costs an eager LeNet step
   (reads a step times the property's cost over a slot read);
24. ``gluon_ssd`` — ``examples/ssd_detection.py``'s loop at its
   published settings (module comment above ``GLUON_SSD``): TinySSD,
   batch 32, 150 Adam iterations through ``MultiBoxPrior``,
   ``MultiBoxTarget`` and ``smooth_l1``, then 64 images through
   ``MultiBoxDetection``: the example's mIoU above 0.4, losses finite
   and falling, the first 3 within ``GLUON_LENET_RTOL`` of the host run,
   the hybridized forward within 1e-5 of eager with ``MultiBoxPrior``
   inside its graph (not called by a replay); ms an iteration split into
   forward, ``MultiBoxTarget``, loss, backward and step, and the
   evaluation's forward and ``MultiBoxDetection`` ms;
25. ``symbolic`` — the symbolic API (module comment above
   ``SYMBOLIC_LENET``): ``examples/lenet_symbol.py``'s ``Module.fit`` at
   its settings (the first 3 batches within ``GLUON_LENET_RTOL`` of the
   host, accuracy at least the JAX package's less 0.02, 2 programs after
   the first batch and 3 after ``score``); ``gluon_flash``'s encoder
   layer composed over Symbols and trained 5 SGD steps through
   ``Module`` (step 1's output and qkv gradient against the eager Gluon
   step, every step against the host's Module; B1-B3 one wrapper launch
   each in the first step, none after, one record each per traced step
   inside the Executor's graphs; 2 programs); ``export`` /
   ``SymbolBlock.imports`` of the hybridized LeNet, the layer's symbol
   as a hybridized SymbolBlock (B1 in its CachedOp graph) and the JAX
   package's symbol file ``tests/fixtures/jax_symbol_graph.json`` on the
   card against the host; a ``BucketingModule`` of the layer over L
   128 / 256 / 512 (one weight object per name, at most 6 programs,
   B1-B3 at each L); the LeNet ``Module.fit`` runs with
   ``monitor=Monitor(interval=16)`` (weights, gradients and the output
   statted at that interval), and a hybridized Gluon LeNet launches as
   many graphs a step monitored as not (``SYMBOLIC_MONITOR``);
26. ``word_lm`` — ``examples/word_language_model.py``'s loop at its own
   sizes (module comment above ``WORD_LM``): 3 epochs on the card,
   perplexity below the unigram's, the first 3 losses within 1e-5
   relative of the host run, ms a batch and s an epoch; then Zaremba's
   medium LSTM LM (vocabulary 33,278, 650 wide, bptt 35, batch 20,
   untied) with ``sparse_grad=True`` and then ``False``, 2 warm-up and
   10 timed lazy-Adam steps each: ms a step, host and device ms, idle
   share, the sparse conversions' host syncs a step and the embedding
   rows a step touches; one step from the same weights and batch on the
   card and on the host (loss 1e-5 relative, embedding gradient 1e-5 of
   its max, updated rows and moments rtol 1e-4 / atol 1e-6, untouched
   rows and their moments bit for bit as before the step); the sparse
   run's loss finite and falling; ``tostype("row_sparse")`` refused
   inside a capture; a hybridized LSTM's inter-layer dropout drawing new
   masks at each replay of its graph; ``nd.sparse`` (CSR ``dot`` with and without
   ``transpose_a``, row-sparse round trip, ``retain``,
   ``row_sparse_pull`` from a ``device`` store) on the card against the
   host;
27. ``model_zoo`` — (module comment above ``MODEL_ZOO``) ResNet-50
   trained at 224x224, batch 32, SGD: 2 eager steps, then hybridized,
   the first hybridized loss within 1e-5 relative of the eager loss
   from the same state and the loss falling; ms a step, samples/s, host
   and device ms, idle share, capture seconds and pool bytes; then 11
   models, one of each family and block kind of the zoo's table, in
   inference on the card against the host from the same weights, logits
   within 1e-4 of max|logit|;
27b. ``imagenet`` — (module comment above ``IMAGENET``)
   ``examples/train_imagenet.py``'s RecordIO pipeline: 256 PNG records
   at 224x224 written by the port's built-in codec, ``ImageRecordIter``
   (shuffle, mirror, 2 decode threads) feeding the zoo's ResNet-50 in
   bfloat16 through ``ShardedTrainer`` (SGD) for the example's 60
   iterations, then the train-set accuracy: the example's criterion,
   batches on the card equal to the host's, two copies to the card and
   one back (the loss) a traced step; ms a step, the data wait, the
   producer's ms a batch with 1 and 2 threads, the idle share; the
   native library on the card's machine (its JPEG tier against
   ``CARD_HAS_LIBJPEG``) and the codec tiers; ``ImageIter`` and
   ``ImageDetIter`` batches on the card equal to the host's;
28. ``ops_card`` — every op of the op library's 160-name long tail, on the
   card against the port's CPU over ``_ops_card_specs``' seeded inputs
   (module comment above ``OPS_CARD_NEW``: forward bit for bit for
   integer and quantized outputs, fp32 rtol 1e-5 / atol 1e-6,
   decompositions 1e-4 of max, gradients 1e-4 of max), the samplers'
   moments on the card, a captured sampler drawing anew at each replay,
   ``boolean_mask`` refusing capture, and the ``RNN`` op at
   ``examples/word_language_model.py``'s widths.

Run after ``gluon_ssd`` (``gluon.contrib``, fp32 with TF32 off):

29. ``gluon_fused`` — ``FusedTrainStep`` (one CUDA graph a step) on
   ``gluon_flash``'s encoder layer against the three-call recipe from
   the same weights (module comment above ``GLUON_FUSED``): 3 steps'
   losses and parameters, ``.grad`` untouched, ms a step, host calls,
   graph launches and B1-B3 records per traced step (1 each), and a
   failure injected into the replay: the reference's "donated" error,
   "reset" on the next call, counts rolled back, training again after
   a reload and ``reset()``;
30. ``gluon_moe`` — one encoder layer at Switch-Base-8's widths
   (``MoEFFN``, 8 experts, capacity factor 1.25; module comment above
   ``SWITCH``) at batch 8 x L 512 trained by ``FusedTrainStep`` against
   the three-call recipe, the first step at batch 2 against the host
   with the router's choices token by token; tokens dropped a step, ms
   a step, device ms split into GEMMs (the einsums), B1-B3 and the
   optimizer, idle share, B1-B3 records per traced step (1 each);
31. ``faster_rcnn`` — ``examples/faster_rcnn.py``'s recipe on synthetic
   arrays (module comment above ``FASTER_RCNN``): 120 eager iterations,
   held-out recall at least 0.5, the first iteration's RPN and ROI
   losses against the host;
32. ``bert_squad`` — (module comment above ``SQUAD_EXAMPLE``) the SQuAD
   example's recipe to exact-match 0.9; the Gluon BERT-large +
   ``BERTForQA`` with the flash path at B 8 x L 384, ragged lengths:
   one eager step against the dense-mask path from the same weights
   (loss 1e-5 relative, each gradient 1e-4 of its max|g|), the first
   loss against the host at B 2 x L 128, 2 eager and 10 hybridized
   steps (one graph a step, the first loss 1e-5 relative of the eager
   one from the same state), 24 B1 / B2 / B3 records a traced step;
33. ``nmt`` — (module comment above ``NMT_EXAMPLE``) the NMT example's
   recipe to beam exact-match 0.9, equal to ``beam_search_host``;
   transformer-big trained 2 eager + 10 hybridized steps, then its
   beam search (one graph replay a decode step, one host sync a 4
   steps) against the same step run eagerly, bit for bit.
34. ``amp`` — (module comment above ``AMP``) ``bert_squad``'s BERT-large
   SQuAD step under ``contrib.amp.init("bfloat16")``: 24 records each of
   the bf16 B1-B3 kernels a traced step, float32 parameters and
   gradients, a forced overflow skipped; float16 over LeNet (the
   scaler's back-off and growth) and over a flash layer (refused with
   ``KernelError``).
35. ``quantize`` — (module comment above ``QUANT_NET``) ``quantize_net``
   over a BERT-large ``BERTClassifier`` (24 B1 records a replay of its
   int8 graph), ``optimize_for(backend="inference")`` (no Dropout, 24 B1
   records a replay), ``examples/quantize_int8.py``'s recipe,
   ``quantize_model`` through ``Module``, and two layers at BERT-large
   width quantized on the card against the host.
36. ``np_card`` — (module comment above ``NP_CARD_TOL``) a table of
   ``mx.np`` / ``mx.npx`` calls on the card against the host, and an
   ``mx.np`` block hybridized into one CUDA graph.

Then the kernel summary line (each kernel's fp32 numbers, and its bf16
ones under ``bfloat16``; ``launches`` is its wrapper's count on the
main path: for B4 and B5 the ``serve`` engine's, for B1-B3 the graphs
trainers' of ``train`` over both dtypes.  B4 and B5 also give
``launches_generate`` (``predict``'s ``ModelServer.generate``) and
``traced_serve_kernel_records`` from ``serve_trace``; B1 gives
``launches_predict`` and ``traced_predict_kernel_records`` over
``traced_predict_batches`` from ``predict_trace``, its fp32 times at
the bucket-16 shape (``predict_bucket16``), ``launches_artifact``
(``artifact``'s captures) and ``traced_artifact_kernel_records`` over
``traced_artifact_replays`` from ``artifact_trace``,
``launches_artifact_quant`` (``artifact_quant``'s captures per
artifact) and ``traced_artifact_quant_kernel_records`` over
``traced_artifact_quant_replays`` from ``artifact_quant_trace``,
``launches_replicas`` (``replicas``' captures) and
``traced_replicas_kernel_records`` over ``traced_replicas_replays``
from ``replicas_trace``; B1, B4 and B5 give ``launches_traffic``
(``traffic``'s captures, scale-ups' included) and
``traced_traffic_kernel_records`` from ``traffic_trace``; B4 and B5
give ``launches_replicas`` and list every ``kernels`` row with its
split; B1-B3 give, per dtype,
``launches_graphs`` and ``launches_eager`` (``train``'s two trainers
apart) and ``traced_train_kernel_records`` over
``traced_train_replays`` from ``train_graphs``, and
``launches_durability`` (``durability``'s two captures) and
``traced_durability_kernel_records`` from ``durability_trace``, and
``launches_dist_nccl`` (two trainers' eager first steps),
``traced_dist_nccl_kernel_records`` (one traced grouped replay),
``launches_dist_tp`` and ``launches_dist_dp_int8`` (one rank's, 3
steps), and ``launches_gluon_flash``, ``launches_gluon_dist`` (rank
0's), ``launches_gluon_hybrid`` and
``traced_gluon_hybrid_kernel_records`` (the lazy-forward run's) from
the Gluon phases, and ``launches_symbolic`` (the encoder Module's
first step), ``traced_symbolic_kernel_records`` (its traced replays)
and ``launches_symbolic_bucketing`` (each bucket's first step) from
``symbolic``, ``launches_gluon_fused`` / ``launches_gluon_moe`` (each
``FusedTrainStep``'s eager first step) with
``traced_gluon_fused_kernel_records`` /
``traced_gluon_moe_kernel_records`` (their traced replays), and
``launches_dist_ep`` (one rank's, 3 steps), ``launches_bert_squad`` and
``traced_bert_squad_kernel_records`` (its hybridized steps),
``launches_nmt`` (none), and ``launches_amp_bf16`` /
``traced_amp_bf16_kernel_records`` (``amp``'s hybridized steps, bf16
kernels); B1 also gives ``launches_quantize``,
``traced_quantize_kernel_records`` and
``traced_optimize_for_kernel_records`` (three traced replays each);
B4 gives ``launches_gluon_nd`` (the
``nd.ragged_paged_attention_op`` call)), the
``nvidia-smi`` name/power-limit line,
and as the last line ``{"ok": true, "device": {...}}``.  Any failed
check raises and the script exits non-zero without that line; it never
runs on the CPU.

Usage: ``python3 chip_smoke.py`` from the repository root (one card).
``--durability-child`` is the entry of ``durability_signal``'s child
processes, ``--dist-worker`` that of the ``dist_*`` phases' ranks and
``--gluon-worker`` that of ``gluon_dist``'s, which the script starts
itself.
"""
import collections
import contextlib
import functools
import gc
import json
import logging
import math
import os
import shutil
import subprocess
import sys
import tempfile
import threading
import time

import numpy as np

# GPT-2 small (openai-community/gpt2 config.json): n_embd 768, n_head 12,
# n_layer 12, n_inner 4 * 768, vocab 50257, n_positions 1024,
# gelu_new (= gelu_tanh), layer_norm_epsilon 1e-5
GPT2_SMALL = dict(vocab_size=50257, units=768, hidden_size=3072,
                  num_layers=12, num_heads=12, max_length=1024,
                  activation="gelu_tanh", layer_norm_eps=1e-5)
# BERT-large (google-research/bert BERT-Large bert_config.json): hidden
# 1024, 24 layers, 16 heads, intermediate 4096, gelu (erf), vocab 30522,
# type vocab 2, max_position 512, layer_norm_eps 1e-12
BERT_LARGE = dict(vocab_size=30522, units=1024, hidden_size=4096,
                  num_layers=24, num_heads=16, max_length=512)
HBM_BYTES_PER_S = 3.35e12               # H100 SXM HBM3
# H100 SXM, dense.  fp32: the least time at fp32 accuracy is 3xTF32 on the
# tensor cores (three TF32 products per fp32 product, 494.7 / 3 = 165
# TFLOP/s), not fp32 FMA on the CUDA cores (67 TFLOP/s); bf16 989 TFLOP/s.
PEAK_FLOPS = {"float32": 494.7e12 / 3, "bfloat16": 989e12}
TOL = {"float32": dict(atol=1e-4, rtol=1e-4),
       "bfloat16": dict(atol=2e-2, rtol=0.0)}
# B4 against its split mirror (_decode_split_reference), which cuts the
# context and rounds P to bf16 against 16-token tiles as the kernel does:
# fp32 differs only in summation order; bf16 by one rounding of the
# output (rtol 2^-7) and, rarely, one P rounded to the neighbouring bf16
# value where the two sides' fp32 P straddle a rounding boundary.
MIRROR_TOL = {"float32": dict(atol=1e-5, rtol=1e-5),
              "bfloat16": dict(atol=2e-3, rtol=2 ** -7)}
# Flash kernels vs their plain versions.  fp32 (TF32 off): both sides sum
# the same fp32 products in other orders, so O and LSE agree to 1e-4;
# a gradient sums up to 2048 rows or keys, so it is held to 1e-3 of its
# tensor's max|grad|.  bf16: inputs, P and dS are rounded to bf16 at the
# same places on both sides, but the kernel rounds P against the running
# max of its key tile and the plain version against the row's final
# max, a bf16 ulp (2^-8) apart, so O is held to 2e-2 absolute and the
# gradients to 5e-2 of max|grad|; LSE stays fp32 arithmetic (1e-4).
FLASH_TOL = {"float32": dict(out=1e-4, out_rtol=1e-4, grad=1e-3),
             "bfloat16": dict(out=2e-2, out_rtol=0.0, grad=5e-2)}
# fp32 B1-B3 run 3xTF32 products, fp32-accurate: besides FLASH_TOL each
# gradient is held to 1e-5 of its max|grad|, O to 1e-5 of its max|O| and
# LSE to 1e-5 (tests/test_torch_flash_attention.py holds the CPU mirrors
# of that arithmetic to 1e-5 of the JAX package; on the card the kernels
# land within ~1e-6 of fp64: mxnet_tpu_torch/tools/flash_*_variants.py).
TF32X3_GRAD_TOL = 1e-5
TF32X3_OUT_TOL = 1e-5
TF32X3_LSE_TOL = 1e-5
# the fp32 B1-B3 kernels and the SASS instruction of their products
TF32_KERNELS = {"flash_attention_fwd": "flash_fwd_tf32_kernel",
                "flash_attention_bwd_dq": "flash_bwd_dq_tf32_kernel",
                "flash_attention_bwd_dkv": "flash_bwd_dkv_tf32_kernel"}
TF32_HMMA = "HMMA.1688.F32.TF32"
PAGE_SIZE, POOL_PAGES, MAX_BATCH = 16, 513, 8
# CUDA-graph replays against the eager adapter on the same inputs: the
# same kernels run on the same data, so the logits are expected bit for
# bit (reported); held to 1e-5 of max|logit| in case the library picks
# another GEMM algorithm for the capture stream's workspace
GRAPH_TOL = 1e-5
# the predict phase: ModelServer over a BERTClassifier on bert_24_1024_16,
# L = 128, buckets {1, 2, 4, 8, 16}, 4 dispatch workers; 8 clients of 12
# requests of 1, 2, 3 or 5 rows
PREDICT_L, PREDICT_MAX_BATCH, PREDICT_WORKERS = 128, 16, 4
PREDICT_CLIENTS, PREDICT_REQUESTS, PREDICT_ROWS = 8, 12, (1, 2, 3, 5)
# served logits against the eager forward of the same weights on the
# request alone, and against the dense (use_flash=False) path: fp32 with
# TF32 off through 24 layers, where the bucket's GEMMs run at another M
# than the request's and so sum in another order; held to 1e-4 of the
# traffic's max |logit|
PREDICT_TOL = 1e-4
# the decode batch's positions in the profile phase (B4's "decode_step"
# row in the kernels phase runs the same contexts)
PROFILE_POSITIONS = (377, 280, 179, 450, 112, 92, 230, 64)
# substrings of cuBLAS / CUTLASS matrix-product kernel names (nvjet_*
# are the H100 cuBLAS kernels of this PyTorch build)
GEMM_TAGS = ("gemm", "cutlass", "sm90_", "nvjet")


# the script's start: each phase's line says how far in it ended
_T0 = time.perf_counter()


def emit(phase, **fields):
    print(json.dumps({"phase": phase,
                      "at_s": round(time.perf_counter() - _T0, 1),
                      **fields}), flush=True)


def check(cond, msg):
    if not cond:
        raise RuntimeError(f"chip_smoke: {msg}")


def nvidia_smi():
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60, check=True)
    return out.stdout.strip().splitlines()[0]


def sass_instructions(lib, prefix):
    """{kernel: {mnemonic: count}} of the SASS instructions starting with
    ``prefix`` in each kernel of the shared library ``lib``
    (``cuobjdump -sass``)."""
    tool = shutil.which("cuobjdump") or "/usr/local/cuda/bin/cuobjdump"
    if not os.path.exists(tool):
        raise RuntimeError("chip_smoke: cuobjdump not found")
    out = subprocess.run([tool, "-sass", lib], capture_output=True,
                         text=True, timeout=300, check=True).stdout
    found, fn = {}, None
    for ln in out.splitlines():
        if "Function : " in ln:
            fn = ln.split("Function : ", 1)[1].strip()
            found.setdefault(fn, {})
        elif fn is not None:
            for tok in ln.replace(";", " ").split():
                if tok.startswith(prefix):
                    found[fn][tok] = found[fn].get(tok, 0) + 1
    return found


def check_tf32_build(build, built):
    """fp32 B1-B3: no spills at D = 64 (ptxas), and every instantiation's
    products are TF32 tensor-core instructions (SASS)."""
    for src, kernel in TF32_KERNELS.items():
        if src in built:
            lines = [ln for ln in ptxas_summary(built[src]["ptxas"])
                     if f"{kernel}ILi64E" in ln]
            check(lines and all("0 bytes spill stores, 0 bytes spill loads"
                                in ln for ln in lines),
                  f"build: fp32 {kernel}<64> spills: {lines}")
        sass = {fn: ops for fn, ops in sass_instructions(
            build.library_path(src), "HMMA").items() if kernel in fn}
        check(len(sass) == 4 and all(ops.get(TF32_HMMA) for ops in
                                     sass.values()),
              f"build: fp32 {kernel} lacks {TF32_HMMA}: {sass}")
        emit("build_sass", source=src, hmma={fn[:60]: ops
                                             for fn, ops in sass.items()})


def ptxas_summary(log):
    """One line per compiled kernel from ``nvcc -Xptxas -v``: its
    (mangled) name with registers and spills, plus any ptxas warning
    (e.g. wgmma serialised)."""
    out, fn, spill = [], None, ""
    for ln in (x.strip() for x in log.splitlines()):
        if "Function properties for" in ln:
            fn = ln.rsplit(" ", 1)[-1]
        elif "spill" in ln:
            spill = ln
        elif "registers" in ln and fn:
            out.append(f"{fn[:72]}: {ln.split(':', 1)[-1].strip()}; {spill}")
        elif "arning" in ln or "Performance" in ln:
            out.append(ln)
    return out


def phase_build_cache(build, compile_cache):
    """The persistent tier on the card, as two fresh checkouts with
    ``MXNET_COMPILE_CACHE_DIR`` set to one new directory see it: a build
    into an empty build directory compiles every library with ``nvcc``
    and stores it in the cache; a build into a second empty directory
    must take every one from the cache, byte for byte, without ``nvcc``.
    Both directories live under ``build/`` and are removed; the
    environment and ``BUILD_DIR`` are restored.  The cache stays for
    ``durability_signal``'s children; returns its directory."""
    root = tempfile.mkdtemp(dir=os.path.dirname(build.BUILD_DIR))
    saved_dir = build.BUILD_DIR
    saved_env = os.environ.get("MXNET_COMPILE_CACHE_DIR")
    try:
        os.environ["MXNET_COMPILE_CACHE_DIR"] = os.path.join(root, "cache")
        runs = {}
        for run in ("first", "second"):
            build.BUILD_DIR = os.path.join(root, run)
            t0 = time.perf_counter()
            got = build.build()
            runs[run] = (time.perf_counter() - t0, got)
        (cold_s, cold), (warm_s, warm) = runs["first"], runs["second"]
        check(not any(b["cached"] for b in cold.values()),
              "build_cache: a library came from a new, empty cache")
        for name in build.SOURCES:
            with open(cold[name]["path"], "rb") as f, \
                    open(warm[name]["path"], "rb") as g:
                check(warm[name]["cached"] and f.read() == g.read(),
                      f"build_cache: {name} did not come from the cache "
                      f"byte for byte")
        emit("build_cache", nvcc_seconds=cold_s, cache_seconds=warm_s,
             libraries=len(warm),
             cache=compile_cache.get_default().stats())
    finally:
        build.BUILD_DIR = saved_dir
        if saved_env is None:
            os.environ.pop("MXNET_COMPILE_CACHE_DIR", None)
        else:
            os.environ["MXNET_COMPILE_CACHE_DIR"] = saved_env
        for run in ("first", "second"):
            shutil.rmtree(os.path.join(root, run), ignore_errors=True)
    return os.path.join(root, "cache")


# ---------------------------------------------------------------- timing
class Timer:
    """Per-launch CUDA-event timing with the 50 MB L2 flushed before
    every launch (outside the timed window), as the decode step finds
    the pool: each layer's pages are cold.

    By default the card spins for ~0.5 ms (``torch.cuda._sleep``) before
    the start event, so the host has enqueued the call before the card
    reaches it and the events read device time only.  ``with_host=True``
    leaves the spin out: the card then idles from the start event until
    the host has enqueued the call, so a call whose host side (argument
    checks, allocation, ``ctypes``) outlasts the flush reads its host
    time instead."""

    SPIN_CYCLES = 1_000_000

    def __init__(self, torch, dev):
        self.torch = torch
        self.flush = torch.empty(64 << 20, dtype=torch.uint8, device=dev)

    def __call__(self, fn, iters=30, warmup=3, with_host=False):
        torch = self.torch
        for _ in range(warmup):
            fn()
        pairs = []
        for _ in range(iters):
            self.flush.zero_()
            if not with_host:
                torch.cuda._sleep(self.SPIN_CYCLES)
            a = torch.cuda.Event(enable_timing=True)
            b = torch.cuda.Event(enable_timing=True)
            a.record()
            fn()
            b.record()
            pairs.append((a, b))
        torch.cuda.synchronize()
        return float(np.median([a.elapsed_time(b) for a, b in pairs]))


def bound(bytes_moved, flops, dtype):
    t_bytes = bytes_moved / HBM_BYTES_PER_S
    t_ops = flops / PEAK_FLOPS[dtype]
    return (max(t_bytes, t_ops) * 1e3,
            "bytes" if t_bytes >= t_ops else "operations")


# --------------------------------------------------------------- kernels
def phase_kernels(torch, dev, timer):
    import torch.nn.functional as F

    from mxnet_tpu_torch.ops import paged_attention as pa
    from mxnet_tpu_torch.serving.batcher import next_bucket
    g = torch.Generator(device="cpu").manual_seed(0)
    B, H, D, P = MAX_BATCH, GPT2_SMALL["num_heads"], 64, 64
    N = B * P + 1
    T = P * PAGE_SIZE
    perm = torch.randperm(N - 1, generator=g)[:B * P] + 1
    bt = perm.reshape(B, P).to(torch.int32).to(dev)
    k32 = torch.randn(N, PAGE_SIZE, H, D, generator=g).to(dev)
    v32 = torch.randn(N, PAGE_SIZE, H, D, generator=g).to(dev)
    ctx = torch.tensor([0, 1, 16, 17, 300, 511, 777, 1024],
                       dtype=torch.int32, device=dev)
    q_dec = torch.randn(B, H, D, generator=g).to(dev)
    # B5: (label, W, starts, lengths), slot b reading row b % B of the
    # block table; "served" is what a prefix-cache hit launches:
    # one slot, a 256-token cached prefix, the 37-token tail padded to the
    # engine's width bucket
    served_w = next_bucket(37, GPT2_SMALL["max_length"])
    verify_cases = [
        ("W1", 1, [0, 1, 15, 16, 299, 510, 776, 1023],
         [1, 0, 1, 1, 1, 1, 1, 1]),
        ("W5", 5, [0, 4, 15, 16, 300, 700, 1019, 0],
         [5, 0, 5, 3, 5, 1, 5, 5]),
        ("W256", 256, [0, 0, 3, 16, 100, 511, 700, 768],
         [256, 0, 200, 256, 17, 1, 256, 256]),
        ("served", served_w, [256], [37]),
        # 24 slots x 12 heads fill two waves with 16-row tiles: no split
        ("W1_B24", 1, [0, 1, 15, 16, 299, 510, 776, 1023] * 3,
         [1, 0, 1, 1, 1, 1, 1, 1] * 3),
    ]
    q_ver = {label: torch.randn(len(st), W, H, D, generator=g).to(dev)
             for label, W, st, _ in verify_cases}

    def gathered(kp, vp, bt=bt):
        nb = bt.shape[0]
        k = kp[bt.long()].reshape(nb, T, H, D).transpose(1, 2)
        v = vp[bt.long()].reshape(nb, T, H, D).transpose(1, 2)
        return k.contiguous(), v.contiguous()

    # B4: (label, context_lens); "mixed" spans an inactive slot to the
    # full table, "decode_step" is the profile phase's decode batch (its
    # positions + 1: the token just written is in the context)
    decode_cases = [
        ("mixed", ctx),
        ("decode_step", torch.tensor(
            [p + 1 for p in PROFILE_POSITIONS], dtype=torch.int32,
            device=dev)),
    ]
    report = {}
    # ---- B4: decode attention
    rows = []
    plan = pa._decode_plan(B, H, D, T, PAGE_SIZE)
    for dtype in ("float32", "bfloat16"):
        dt = getattr(torch, dtype)
        q, kp, vp = q_dec.to(dt), k32.to(dt), v32.to(dt)
        k_g, v_g = gathered(kp, vp)
        for label, lens in decode_cases:
            got = pa.ragged_paged_attention(q, kp, vp, bt, lens)
            want = pa.ragged_paged_attention_reference(q, kp, vp, bt, lens)
            mirror = pa._decode_split_reference(
                q.cpu(), kp.cpu(), vp.cpu(), bt.cpu(), lens.cpu(),
                plan.n_split, plan.chunk).to(dev)
            torch.cuda.synchronize()
            err = float((got.float() - want.float()).abs().max())
            merr = float((got.float() - mirror.float()).abs().max())
            ok = torch.allclose(got.float(), want.float(), **TOL[dtype])
            mok = torch.allclose(got.float(), mirror.float(),
                                 **MIRROR_TOL[dtype])
            # ctx 0: exact zeros
            zero = all(bool(torch.all(got[b] == 0))
                       for b in range(B) if int(lens[b]) == 0)
            check(ok and mok and zero,
                  f"ragged_paged_attention {dtype} {label}: max error "
                  f"{err}, against the split mirror {merr} (inactive slot "
                  f"zeros: {zero})")
            mask = (torch.arange(T, device=dev)[None, :]
                    < lens[:, None])[:, None, None, :]   # (B, 1, 1, T)
            elt = kp.element_size()
            n_tok = int(lens.clamp(max=T).sum())
            b_moved = (2 * n_tok * H * D + 2 * B * H * D) * elt \
                + bt.numel() * 4 + lens.numel() * 4
            bound_ms, bound_by = bound(b_moved, 4 * n_tok * H * D, dtype)
            rows.append(dict(
                dtype=dtype, shape=label, context_lens=lens.tolist(),
                n_split=plan.n_split, chunk=plan.chunk, max_abs_err=err,
                mirror_max_abs_err=merr,
                ms=timer(lambda: pa.ragged_paged_attention(q, kp, vp, bt,
                                                           lens)),
                ms_with_host=timer(lambda: pa.ragged_paged_attention(
                    q, kp, vp, bt, lens), with_host=True),
                plain_ms=timer(lambda: pa.ragged_paged_attention_reference(
                    q, kp, vp, bt, lens)),
                library_ms=timer(lambda: F.scaled_dot_product_attention(
                    q[:, :, None], k_g, v_g, attn_mask=mask)),
                bound_ms=bound_ms, bound_by=bound_by))
    report["ragged_paged_attention"] = rows
    report["ragged_paged_attention_repeat"] = _decode_repeat_check(
        torch, pa, q_dec, k32, v32, bt, ctx)
    # ---- B5: verify attention
    rows = []
    for dtype in ("float32", "bfloat16"):
        dt = getattr(torch, dtype)
        kp, vp = k32.to(dt), v32.to(dt)
        for label, W, st_l, ln_l in verify_cases:
            nb = len(st_l)
            bt_c = bt[torch.arange(nb, device=dev) % B].contiguous()
            k_g, v_g = gathered(kp, vp, bt_c)
            q = q_ver[label].to(dt)
            st = torch.tensor(st_l, dtype=torch.int32, device=dev)
            ln = torch.tensor(ln_l, dtype=torch.int32, device=dev)
            got = pa.ragged_paged_verify(q, kp, vp, bt_c, st, ln)
            want = pa.ragged_paged_verify_reference(q, kp, vp, bt_c, st, ln)
            torch.cuda.synchronize()
            err = float((got.float() - want.float()).abs().max())
            ok = torch.allclose(got.float(), want.float(), **TOL[dtype])
            pad_zero = all(bool(torch.all(got[b, ln_l[b]:] == 0))
                           for b in range(nb))
            check(ok and pad_zero,
                  f"ragged_paged_verify {dtype} {label}: max error {err} "
                  f"(rows past lengths zero: {pad_zero})")
            if W == 1:
                # W = 1 verify is decode attention at ctx = start + 1
                dec = pa.ragged_paged_attention(
                    q[:, 0], kp, vp, bt_c, torch.where(ln > 0, st + 1, 0))
                werr = float((got[:, 0].float() - dec.float()).abs().max())
                check(werr <= TOL[dtype]["atol"],
                      f"verify W=1 vs decode {dtype}: {werr}")
            rows_pos = st[:, None] + torch.arange(W, device=dev)[None]
            valid = torch.arange(W, device=dev)[None] < ln[:, None]
            mask = ((torch.arange(T, device=dev)[None, None]
                     <= rows_pos[:, :, None]) & valid[:, :, None])[:, None]
            qt = q.transpose(1, 2)
            elt = kp.element_size()
            n_kv = sum(min(s + n, T) for s, n in zip(st_l, ln_l) if n)
            pairs = sum(min(s + w + 1, T) for s, n in zip(st_l, ln_l)
                        for w in range(n))
            b_moved = (2 * n_kv * H * D + 2 * nb * W * H * D) * elt \
                + bt_c.numel() * 4 + 2 * nb * 4
            bound_ms, bound_by = bound(b_moved, 4 * pairs * H * D, dtype)
            plan = pa._verify_plan(nb, W, H, D, T, PAGE_SIZE)
            rows.append(dict(
                dtype=dtype, shape=label, W=W, B=nb, n_split=plan.n_split,
                rows_per_block=plan.rows, chunk=plan.chunk, max_abs_err=err,
                ms=timer(lambda: pa.ragged_paged_verify(q, kp, vp, bt_c, st,
                                                        ln)),
                ms_with_host=timer(lambda: pa.ragged_paged_verify(
                    q, kp, vp, bt_c, st, ln), with_host=True),
                plain_ms=timer(lambda: pa.ragged_paged_verify_reference(
                    q, kp, vp, bt_c, st, ln)),
                library_ms=timer(lambda: F.scaled_dot_product_attention(
                    qt, k_g, v_g, attn_mask=mask)),
                bound_ms=bound_ms, bound_by=bound_by))
    report["ragged_paged_verify"] = rows
    emit("kernels", shapes=dict(B=B, H=H, D=D, page_size=PAGE_SIZE,
                                pages_per_seq=P, pool_pages=N,
                                context_lens=ctx.tolist(),
                                verify={label: dict(W=W, starts=s, lengths=n)
                                        for label, W, s, n in verify_cases},
                                served_width=served_w),
         results=report)
    return report


def _decode_repeat_check(torch, pa, q, k32, v32, bt, ctx):
    """B4's in-launch merge leaves its (b, h) arrival counters at zero:
    three calls on each of two shapes, interleaved (the serving batch,
    and three slots of it whose plan splits more finely, so another
    workspace), must give bitwise-equal outputs for equal inputs.  A
    counter left non-zero would make a later call merge too early or
    never."""
    B, H, D = q.shape
    T = bt.shape[1] * k32.shape[1]
    small = (bt[:3].contiguous(),
             torch.tensor([T - 24, 0, 300], dtype=torch.int32,
                          device=q.device))
    plans = [pa._decode_plan(B, H, D, T, k32.shape[1]),
             pa._decode_plan(3, H, D, T, k32.shape[1])]
    check(plans[0].workspace != plans[1].workspace and all(
        p.n_split > 1 for p in plans),
        f"repeat check: the two shapes must split into different "
        f"workspaces: {plans}")
    out = {}
    for dtype in ("float32", "bfloat16"):
        dt = getattr(torch, dtype)
        kp, vp = k32.to(dt), v32.to(dt)
        calls = [(q.to(dt), bt, ctx), (q[:3].to(dt).contiguous(), *small)]
        runs = [[], []]
        for _ in range(3):
            for i, (qq, tb, ln) in enumerate(calls):
                runs[i].append(pa.ragged_paged_attention(qq, kp, vp, tb, ln))
        torch.cuda.synchronize()
        same = [all(torch.equal(r[0], x) for x in r[1:]) for r in runs]
        check(all(same), f"ragged_paged_attention {dtype}: repeated calls "
                         f"differ (bitwise equal per shape: {same})")
        out[dtype] = dict(calls_per_shape=3, n_split=[p.n_split
                                                      for p in plans],
                          bitwise_equal=same)
    return out


def phase_head_dims(torch, dev):
    """Every head dim the kernels are compiled for, fp32 and bf16, at a
    small shape (partial pages, an inactive slot, a multi-page context)
    against the plain versions: the main path only runs head_dim 64.
    B5 also runs windows that straddle its 16- and 64-row tiles (W = 17,
    65) over contexts of up to 768 tokens, which its plan splits into at
    least three chunks."""
    from mxnet_tpu_torch.ops import paged_attention as pa
    g = torch.Generator(device="cpu").manual_seed(3)
    B, H, P = 3, 2, 48
    N = B * P + 1
    T = P * PAGE_SIZE
    bt = (torch.randperm(N - 1, generator=g)[:B * P] + 1).reshape(B, P)
    bt = bt.to(torch.int32).to(dev)
    ctx = torch.tensor([0, 7, 50], dtype=torch.int32, device=dev)
    # B4 over contexts its plan splits: 768 tokens span 12 chunks
    ctx_split = torch.tensor([0, 130, 768], dtype=torch.int32, device=dev)
    decode_plan = pa._decode_plan(B, H, 64, T, PAGE_SIZE)
    check(-(-768 // decode_plan.chunk) >= 3,
          f"head_dims: the decode context spans under three chunks: "
          f"{decode_plan}")
    verify = {1: ([0, 6, 49], [0, 1, 1]), 5: ([0, 3, 40], [5, 0, 5]),
              33: ([0, 1, 30], [33, 12, 0]),
              17: ([0, 700, 301], [17, 16, 0]),
              65: ([5, 640, 100], [65, 40, 64]),
              "long_1": ([767, 0, 512], [1, 1, 1])}
    splits = {}
    for key, (st_l, _) in verify.items():
        W = int(str(key).rsplit("_", 1)[-1])
        splits[str(key)] = pa._verify_plan(B, W, H, 64, T, PAGE_SIZE).n_split
    check(max(splits.values()) >= 3,
          f"head_dims: no verify case spans three splits: {splits}")
    worst = {}
    for D in pa._HEAD_DIMS:
        k32 = torch.randn(N, PAGE_SIZE, H, D, generator=g).to(dev)
        v32 = torch.randn(N, PAGE_SIZE, H, D, generator=g).to(dev)
        for dtype in ("float32", "bfloat16"):
            dt = getattr(torch, dtype)
            kp, vp = k32.to(dt), v32.to(dt)
            q = torch.randn(B, H, D, generator=g).to(dev, dt)
            errs = []
            for lens in (ctx, ctx_split):
                got = pa.ragged_paged_attention(q, kp, vp, bt, lens)
                want = pa.ragged_paged_attention_reference(q, kp, vp, bt,
                                                           lens)
                errs.append(float((got.float() - want.float()).abs().max()))
                check(torch.allclose(got.float(), want.float(),
                                     **TOL[dtype])
                      and bool(torch.all(got[0] == 0)),
                      f"ragged_paged_attention D={D} {dtype} contexts "
                      f"{lens.tolist()}: {errs[-1]}")
            for key, (st_l, ln_l) in verify.items():
                W = int(str(key).rsplit("_", 1)[-1])
                q = torch.randn(B, W, H, D, generator=g).to(dev, dt)
                st = torch.tensor(st_l, dtype=torch.int32, device=dev)
                ln = torch.tensor(ln_l, dtype=torch.int32, device=dev)
                got = pa.ragged_paged_verify(q, kp, vp, bt, st, ln)
                want = pa.ragged_paged_verify_reference(q, kp, vp, bt, st,
                                                        ln)
                errs.append(float((got.float() - want.float()).abs().max()))
                check(torch.allclose(got.float(), want.float(), **TOL[dtype])
                      and all(bool(torch.all(got[b, ln_l[b]:] == 0))
                              for b in range(B)),
                      f"ragged_paged_verify D={D} W={key} {dtype}: "
                      f"{errs[-1]}")
            worst[f"{D}/{dtype}"] = max(errs)
    torch.cuda.synchronize()
    emit("head_dims", head_dims=list(pa._HEAD_DIMS),
         verify_widths=[str(k) for k in verify], context_tokens=T,
         verify_n_split=splits, decode_context_lens=[ctx.tolist(),
                                                     ctx_split.tolist()],
         decode_n_split=decode_plan.n_split, decode_chunk=decode_plan.chunk,
         max_abs_err=worst)


# --------------------------------------------------------- flash kernels
def _train_batch(vocab, B=8, L=512, seed=0):
    """The training slice's batch (numpy, from ``RandomState(seed)``):
    valid lengths over 128..512 with one row at 512, 0.15 * L masked
    positions per row inside its valid length, MLM and NSP labels."""
    rs = np.random.RandomState(seed)
    valid = rs.randint(128, L + 1, B)
    valid[0] = L
    n_mask = int(0.15 * L)
    inputs = rs.randint(0, vocab, (B, L)).astype(np.int32)
    types = (np.arange(L)[None, :] >= (valid // 2)[:, None]).astype(np.int32)
    positions = np.stack([np.sort(rs.choice(int(v), n_mask, replace=False))
                          for v in valid]).astype(np.int32)
    mlm_y = rs.randint(0, vocab, (B, n_mask)).astype(np.int32)
    nsp_y = rs.randint(0, 2, (B,)).astype(np.int32)
    return (inputs, types, valid.astype(np.float32), positions), \
        (mlm_y, nsp_y)


def _flash_cases():
    """(label, BH, Lq, Lk, D, causal, window, per-row key lengths)."""
    H = BERT_LARGE["num_heads"]
    (_, _, valid, _), _ = _train_batch(BERT_LARGE["vocab_size"])
    train_lens = np.repeat(valid.astype(np.int32), H).tolist()
    mixed = np.repeat([0, 1, 37, 512, 128, 300, 411, 512], H).tolist()
    # the predict path's bucket-16 batch: the traffic's first six
    # requests' valid lengths, then padding rows of length 0
    first = [r for c in _predict_traffic(BERT_LARGE["vocab_size"])
             for r in c][:6]
    pred = np.concatenate([r[2] for r in first])
    pred = np.repeat(np.pad(pred, (0, PREDICT_MAX_BATCH - len(pred))),
                     H).tolist()
    return [
        ("train_batch", 8 * H, 512, 512, 64, False, -1, train_lens),
        ("lengths_0_1_37_512", 8 * H, 512, 512, 64, False, -1, mixed),
        ("causal", 8 * H, 512, 512, 64, True, -1, None),
        ("causal_window128_lengths", 8 * H, 512, 512, 64, True, 128, mixed),
        ("ragged_Lq37_Lk100", 16, 37, 100, 64, False, -1,
         [37, 100, 5, 0] * 4),
        ("head_dim_128", 8 * 8, 512, 512, 128, False, -1,
         np.repeat([512, 300, 1, 0, 77, 512, 256, 129], 8).tolist()),
        # the head-dim sweep (16, 32, 64 above, 128): bf16 B1-B3 take 16
        # and 32 zero-padded to 64 columns
        ("head_dim_16", 8 * 8, 512, 512, 16, True, -1,
         np.repeat([512, 300, 1, 0, 77, 512, 256, 129], 8).tolist()),
        ("head_dim_32", 8 * 8, 512, 512, 32, False, -1,
         np.repeat([512, 300, 1, 0, 77, 512, 256, 129], 8).tolist()),
        ("flash2048", 2 * H, 2048, 2048, 64, False, -1, None),
        ("predict_bucket16", PREDICT_MAX_BATCH * H, PREDICT_L, PREDICT_L,
         64, False, -1, pred),
    ]


def _rel_err(got, want):
    return float((got.float() - want.float()).abs().max()) / max(
        float(want.float().abs().max()), 1e-30)


def phase_flash_kernels(torch, dev, timer):
    """B1, B2 and B3 against their plain versions on the card, fp32 and
    bf16, at the training slice's shapes; each kernel's time, the plain
    version's, the roofline bound and a library yardstick
    (``scaled_dot_product_attention`` and its backward, timed only)."""
    import torch.nn.functional as F

    from mxnet_tpu_torch.base import KernelError
    from mxnet_tpu_torch.ops import flash_attention as fa
    # a head dim outside _HEAD_DIMS is refused before any launch: 256
    # (B2/B3 do not fit; PERF.md) and 24
    for D in (24, 256):
        z = torch.zeros(1, 64, D, device=dev)
        try:
            fa.flash_attention(z, z, z)
        except KernelError:
            continue
        check(False, f"flash_attention ran head dim {D} on the card")
    check({c[4] for c in _flash_cases()} == set(fa._HEAD_DIMS),
          "flash_kernels: the sweep misses a head dim of _HEAD_DIMS")
    g = torch.Generator().manual_seed(5)
    rows = []
    for label, BH, Lq, Lk, D, causal, window, lens in _flash_cases():
        q32 = torch.randn(BH, Lq, D, generator=g)
        k32 = torch.randn(BH, Lk, D, generator=g)
        v32 = torch.randn(BH, Lk, D, generator=g)
        do32 = torch.randn(BH, Lq, D, generator=g)
        ln = torch.tensor(lens if lens is not None else [Lk] * BH,
                          dtype=torch.int32, device=dev)
        vis = fa._visible(Lq, Lk, ln, causal, window, dev).expand(
            BH, Lq, Lk)
        pairs = int(vis.sum())
        keys = int(ln.clamp(max=Lk).sum())
        empty_rows = ~vis.any(-1)                            # (BH, Lq)
        sc = 1.0 / D ** 0.5
        for dtype in ("float32", "bfloat16"):
            dt = getattr(torch, dtype)
            q, k, v, do = (t.to(dev, dt) for t in (q32, k32, v32, do32))
            args = (ln, causal, sc, window)
            out, lse = fa.flash_attention_fwd(q, k, v, *args)
            r_out, r_lse = fa.flash_attention_fwd_reference(q, k, v, *args)
            delta = (do.float() * r_out.float()).sum(-1, keepdim=True)
            bargs = (ln, r_lse, delta, causal, sc, window)
            dq = fa.flash_attention_bwd_dq(q, k, v, do, *bargs)
            r_dq = fa.flash_attention_bwd_dq_reference(q, k, v, do, *bargs)
            dk, dv = fa.flash_attention_bwd_dkv(q, k, v, do, *bargs)
            r_dk, r_dv = fa.flash_attention_bwd_dkv_reference(q, k, v, do,
                                                              *bargs)
            torch.cuda.synchronize()
            tol = FLASH_TOL[dtype]
            err = dict(
                out=float((out.float() - r_out.float()).abs().max()),
                lse=float((lse - r_lse).abs().max()),
                dq=_rel_err(dq, r_dq), dk=_rel_err(dk, r_dk),
                dv=_rel_err(dv, r_dv))
            grad_tol = TF32X3_GRAD_TOL if dtype == "float32" else tol["grad"]
            ok = (torch.allclose(out.float(), r_out.float(), atol=tol["out"],
                                 rtol=tol["out_rtol"])
                  and torch.allclose(lse, r_lse, atol=1e-4, rtol=1e-4)
                  and max(err["dq"], err["dk"], err["dv"]) <= grad_tol)
            if dtype == "float32":
                # fp32 B1 is 3xTF32 too: O to 1e-5 of max|O|, LSE to 1e-5
                err["out_rel"] = _rel_err(out, r_out)
                ok = (ok and err["out_rel"] <= TF32X3_OUT_TOL
                      and err["lse"] <= TF32X3_LSE_TOL)
            # rows that see no key: exact zeros and LSE -1e30
            zero_ok = bool(torch.all(out[empty_rows] == 0)) and bool(
                torch.all(lse[..., 0][empty_rows] == -1e30)) and bool(
                torch.all(dq[empty_rows] == 0))
            check(ok and zero_ok, f"flash kernels {label} {dtype}: errors "
                                  f"{err} (empty rows zero: {zero_ok})")
            abs_err = dict(
                out=err["out"],
                dq=float((dq.float() - r_dq.float()).abs().max()),
                dkv=max(float((dk.float() - r_dk.float()).abs().max()),
                        float((dv.float() - r_dv.float()).abs().max())))
            elt = q.element_size()
            qbytes = BH * Lq * D * elt
            kbytes = keys * D * elt
            stats = BH * Lq * 4
            # bytes each kernel must move once (keys past a row's
            # length are never needed) and the flops of the visible pairs
            b1 = bound(2 * qbytes + 2 * kbytes + stats + BH * 4,
                       4 * pairs * D, dtype)
            b2 = bound(3 * qbytes + 2 * kbytes + 2 * stats + BH * 4,
                       6 * pairs * D, dtype)
            b3 = bound(2 * qbytes + 2 * kbytes + 2 * stats + BH * 4
                       + 2 * BH * Lk * D * elt, 8 * pairs * D, dtype)
            # library yardstick: SDPA with a boolean mask (rows with no
            # visible key come out NaN there; timed only)
            q4, k4, v4 = (t[None].detach().requires_grad_()
                          for t in (q, k, v))
            mask4 = vis[None]
            lib_out = F.scaled_dot_product_attention(q4, k4, v4,
                                                     attn_mask=mask4)
            if label == "train_batch" and dtype == "bfloat16":
                # no atomics and a fixed order of key tiles: a second
                # call repeats the first bit for bit
                out2, lse2 = fa.flash_attention_fwd(q, k, v, *args)
                torch.cuda.synchronize()
                check(torch.equal(out, out2) and torch.equal(lse, lse2),
                      f"flash_attention_fwd {label} {dtype}: two calls "
                      f"differ")
            if label == "train_batch" and dtype == "float32":
                # each block owns its output tile: fp32 B1, B2 and B3
                # repeat too
                out2, lse2 = fa.flash_attention_fwd(q, k, v, *args)
                dq2 = fa.flash_attention_bwd_dq(q, k, v, do, *bargs)
                dk2, dv2 = fa.flash_attention_bwd_dkv(q, k, v, do, *bargs)
                torch.cuda.synchronize()
                check(torch.equal(out, out2) and torch.equal(lse, lse2),
                      f"flash_attention_fwd {label} {dtype}: two calls "
                      f"differ")
                check(torch.equal(dq, dq2) and torch.equal(dk, dk2)
                      and torch.equal(dv, dv2),
                      f"flash_attention_bwd {label} {dtype}: two calls "
                      f"differ")
            row = dict(
                shape=label, dtype=dtype, BH=BH, Lq=Lq, Lk=Lk, D=D,
                causal=causal, window=window, visible_pairs=pairs,
                rel_err=err, max_abs_err=abs_err,
                fwd=dict(ms=timer(lambda: fa.flash_attention_fwd(
                    q, k, v, *args)),
                    plain_ms=timer(lambda: fa.flash_attention_fwd_reference(
                        q, k, v, *args)),
                    library_ms=timer(lambda: F.scaled_dot_product_attention(
                        q4, k4, v4, attn_mask=mask4)),
                    bound_ms=b1[0], bound_by=b1[1]),
                bwd_dq=dict(ms=timer(lambda: fa.flash_attention_bwd_dq(
                    q, k, v, do, *bargs)),
                    plain_ms=timer(
                        lambda: fa.flash_attention_bwd_dq_reference(
                            q, k, v, do, *bargs)),
                    bound_ms=b2[0], bound_by=b2[1]),
                bwd_dkv=dict(ms=timer(lambda: fa.flash_attention_bwd_dkv(
                    q, k, v, do, *bargs)),
                    plain_ms=timer(
                        lambda: fa.flash_attention_bwd_dkv_reference(
                            q, k, v, do, *bargs)),
                    bound_ms=b3[0], bound_by=b3[1]),
                # one backward through SDPA computes dQ, dK and dV: the
                # yardstick of B2 and B3 together
                library_bwd_ms=timer(lambda: torch.autograd.grad(
                    lib_out, (q4, k4, v4), do[None], retain_graph=True)))
            rows.append(row)
            emit("flash_kernels", **row)
            del lib_out, q4, k4, v4
    return rows


# ---------------------------------------------------------------- parity
def assert_logits(got, want, where):
    """rtol 1e-3, atol 1e-3 * max|logit|: 12 fp32 layers summed in
    another order than the dense forward."""
    atol = 1e-3 * float(want.abs().max())
    diff = (got - want).abs()
    bad = diff > atol + 1e-3 * want.abs()
    check(not bool(bad.any()),
          f"{where}: logits off by up to {float(diff.max())} "
          f"(atol {atol})")
    return float(diff.max())


def phase_parity(torch, dev, lm):
    from mxnet_tpu_torch.models import transformer_blocks as tb
    from mxnet_tpu_torch.ops import paged_attention as pa
    from mxnet_tpu_torch.serving.batcher import next_bucket
    from mxnet_tpu_torch.serving.kv_cache import DeviceKVPool, PageGeometry
    L = lm.num_layers
    kw = dict(num_heads=lm.num_heads, page_size=PAGE_SIZE,
              activation=lm._activation, layer_norm_eps=lm._eps)
    geom = PageGeometry(PAGE_SIZE, POOL_PAGES, lm.max_context, L,
                        lm.num_heads, lm.head_dim)
    pool = DeviceKVPool(geom, device=dev)
    params = tb.paged_lm_params(lm)
    rs = np.random.RandomState(1)
    n_prompt, n_steps, n_tail = 300, 32, 37
    seq = rs.randint(0, lm.vocab_size, n_prompt).tolist()
    bt = torch.zeros(geom.pages_per_seq, dtype=torch.int32, device=dev)
    n_pages = geom.pages_for(n_prompt + n_steps + n_tail)
    bt[:n_pages] = torch.from_numpy(
        rs.permutation(POOL_PAGES - 1)[:n_pages] + 1).to(dev)
    bucket = next_bucket(n_prompt, lm.max_context)
    tokens = torch.zeros((1, bucket), dtype=torch.int32, device=dev)
    tokens[0, :n_prompt] = torch.tensor(seq, device=dev)
    worst = 0.0
    with torch.no_grad():
        logits, _, _ = tb.paged_prefill(params, tokens, n_prompt, bt,
                                        pool.k_pages, pool.v_pages, **kw)
        step_logits = [logits]
        for i in range(n_steps):
            seq.append(int(torch.argmax(step_logits[-1])))
            before = pa.ragged_paged_attention.launches
            logits, _, _ = tb.paged_decode_step(
                params, torch.tensor([seq[-1]], dtype=torch.int32,
                                     device=dev),
                torch.tensor([n_prompt + i], dtype=torch.int32, device=dev),
                bt[None], pool.k_pages, pool.v_pages, **kw)
            check(pa.ragged_paged_attention.launches - before == L,
                  "decode step did not launch the decode kernel once per "
                  "layer")
            step_logits.append(logits[0])
        start = len(seq)                  # K/V of 0..start-1 is cached
        seq += rs.randint(0, lm.vocab_size, n_tail).tolist()
        before = pa.ragged_paged_verify.launches
        window = torch.tensor([seq[start:]], dtype=torch.int32, device=dev)
        v_logits, _, _ = tb.paged_verify(params, window, start, n_tail, bt,
                                         pool.k_pages, pool.v_pages, **kw)
        check(pa.ragged_paged_verify.launches - before == L,
              "paged_verify did not launch the verify kernel once per "
              "layer")
        # the speculative-decoding shape: the same window re-judged in a
        # batch of 2 beside an inactive slot (its K/V rewrite is
        # idempotent), padded to the next width bucket
        width = next_bucket(n_tail, lm.max_context)
        win_b = torch.zeros((2, width), dtype=torch.int32, device=dev)
        win_b[0, :n_tail] = window[0]
        tables = torch.stack([bt, torch.zeros_like(bt)])
        b_logits, _, _ = tb.paged_verify_batch(
            params, win_b,
            torch.tensor([start, 0], dtype=torch.int32, device=dev),
            torch.tensor([n_tail, 0], dtype=torch.int32, device=dev),
            tables, pool.k_pages, pool.v_pages, **kw)
        full = lm(torch.tensor([seq], device=dev))[0]
        for i, lg in enumerate(step_logits):
            worst = max(worst, assert_logits(lg, full[n_prompt - 1 + i],
                                             f"decode position "
                                             f"{n_prompt - 1 + i}"))
        worst = max(worst, assert_logits(v_logits, full[start:],
                                         "verify tail"))
        worst = max(worst, assert_logits(b_logits[0, :n_tail], full[start:],
                                         "batched verify"))
    emit("parity", prompt_tokens=n_prompt, decode_steps=n_steps,
         verify_width=n_tail, max_abs_logit_diff=worst,
         max_abs_logit=float(full.abs().max()),
         decode_kernel_launches_per_step=L,
         verify_kernel_launches_per_call=L)
    del pool


# ------------------------------------------------------------- graphs
def _graph_vs_eager(got, want, where):
    """Graph-replayed logits against eager ones on the same inputs:
    within 1e-5 of max|logit|; returns (max abs diff, bitwise equal)."""
    diff = float(np.abs(got - want).max())
    scale = float(np.abs(want).max())
    check(got.shape == want.shape and diff <= GRAPH_TOL * scale,
          f"{where}: graph logits off eager by {diff} (limit "
          f"{GRAPH_TOL} x {scale})")
    return diff, bool(np.array_equal(got, want))


def phase_graphs(torch, dev, lm):
    """``PagedLMAdapter``'s CUDA graphs against ``graphs=False`` at
    GPT-2-small widths: each captured family (prefill at bucket 512, the
    decode step at the profile phase's batch, verify at width 64,
    verify_batch (2, 64)) twice on other inputs, so the first call
    (eager, then captured) and a replay are both held to the eager
    adapter's logits; three interleaved replays of two signatures
    repeat bit for bit and add their launches to the counters;
    ``compiled == programs``; ``refresh()`` with new weights gives a
    fresh adapter's logits through the surviving graphs."""
    from mxnet_tpu_torch.models import TransformerDecoderLM
    from mxnet_tpu_torch.ops import paged_attention as pa
    from mxnet_tpu_torch.serving import PagedLMAdapter
    from mxnet_tpu_torch.serving.batcher import next_bucket
    from mxnet_tpu_torch.serving.kv_cache import PageGeometry
    L = lm.num_layers
    geom = PageGeometry(PAGE_SIZE, POOL_PAGES, lm.max_context, L,
                        lm.num_heads, lm.head_dim)
    # the graphs adapter's own LM (seed 0, lm's weights): refresh() below
    # gives it new weights, and lm serves the later phases
    lm_g = TransformerDecoderLM(**GPT2_SMALL, device=dev,
                                generator=torch.Generator().manual_seed(0))
    lm_g.eval()
    check(all(torch.equal(a, b) for a, b in zip(lm_g.parameters(),
                                                lm.parameters())),
          "graphs: seed 0 did not rebuild the same weights")
    graphs = PagedLMAdapter(lm_g, device=dev)
    eager = PagedLMAdapter(lm, device=dev, graphs=False)
    for a in (graphs, eager):
        a.setup(geom)
    rs = np.random.RandomState(3)
    V = lm.vocab_size
    dec_tokens, positions, tables, nxt = _decode_batch(geom)
    n_prompt, start = 300, 300
    bucket = next_bucket(n_prompt, lm.max_context)
    width = next_bucket(37, lm.max_context)
    table = np.zeros(geom.pages_per_seq, np.int32)
    n_pages = geom.pages_for(start + width)
    table[:n_pages] = np.arange(nxt, nxt + n_pages)

    def prefill_args(n):
        tokens = np.zeros((1, bucket), np.int32)
        tokens[0, :n] = rs.randint(0, V, n)
        return tokens, np.int32(n), table

    def verify_args(n):
        tokens = np.zeros((1, width), np.int32)
        tokens[0, :n] = rs.randint(0, V, n)
        return tokens, np.int32(start), np.int32(n), table

    def batch_args(n):
        tokens = np.zeros((2, width), np.int32)
        tokens[0, :n] = rs.randint(0, V, n)
        return (tokens, np.asarray([start, 0], np.int32),
                np.asarray([n, 0], np.int32),
                np.stack([table, np.zeros_like(table)]))

    # family -> two calls on other inputs: the first is run eagerly and
    # captured, the second replays
    calls = {
        "prefill": [prefill_args(n_prompt), prefill_args(n_prompt - 10)],
        "decode_step": [(dec_tokens, positions, tables),
                        ((dec_tokens + 100) % V, positions, tables)],
        "verify": [verify_args(37), verify_args(30)],
        "verify_batch": [batch_args(37), batch_args(21)],
    }
    # the kernel each family launches L times: its wrapper counts the
    # first call's eager launches, none for the capture that follows it
    # and none for a replay, which does not call it
    wrappers = {"prefill": None, "decode_step": pa.ragged_paged_attention,
                "verify": pa.ragged_paged_verify,
                "verify_batch": pa.ragged_paged_verify}
    worst, bitwise = 0.0, {}
    for family, arg_list in calls.items():
        wrapper = wrappers[family]
        for i, args in enumerate(arg_list):
            before = wrapper and wrapper.launches
            got = getattr(graphs, family)(*args)
            if wrapper is not None:
                rose = wrapper.launches - before
                check(rose == (L if i == 0 else 0),
                      f"graphs: {family} call {i + 1} counted {rose} "
                      f"launches of {wrapper.__name__}")
            want = getattr(eager, family)(*args)
            diff, same = _graph_vs_eager(got, want, f"graphs {family} "
                                         f"call {i + 1}")
            worst = max(worst, diff)
            bitwise[f"{family}_{i + 1}"] = same
    check(graphs.compiled == graphs.programs() == len(calls),
          f"graphs: compiled {graphs.compiled} != programs "
          f"{graphs.programs()} != {len(calls)}")
    check(eager.compiled == 0, "graphs=False captured a graph")

    # three interleaved replays of two signatures repeat bit for bit
    dec_args, ver_args = calls["decode_step"][1], calls["verify"][1]
    outs = {"decode_step": [], "verify": []}
    for _ in range(3):
        for family, args in (("decode_step", dec_args),
                             ("verify", ver_args)):
            outs[family].append(getattr(graphs, family)(*args))
    for family, got in outs.items():
        check(all(np.array_equal(got[0], g) for g in got[1:]),
              f"graphs: interleaved {family} replays differ")
    # a traced replay of each kernel family holds num_layers kernels
    kernels = (pa.ragged_paged_attention, pa.ragged_paged_verify)
    counted = [w.launches for w in kernels]
    take = {}

    def replay_three():
        for f in ("decode_step", "verify", "verify_batch"):
            getattr(graphs, f)(*calls[f][1])

    def traced():
        take["replays"] = graphs.replays()
        replay_three()

    records = _kernel_records(torch, traced, warm=replay_three,
                              where="graphs")
    check(records == {"ragged_paged_attention": L,
                      "ragged_paged_verify": 2 * L},
          f"graphs: traced replays of decode_step, verify and "
          f"verify_batch hold {records} kernels, not {L} / {2 * L}")
    check(graphs.replays() - take["replays"] == 3
          and counted == [w.launches for w in kernels],
          "graphs: a traced call did not replay its graph, or a "
          "wrapper counted a replay")

    # refresh(): new weights copied in place into the captured tensors
    lm_new = TransformerDecoderLM(**GPT2_SMALL, device=dev,
                                  generator=torch.Generator().manual_seed(1))
    lm_new.eval()
    ptrs = [t.data_ptr() for t in graphs.params["cells"][0].values()]
    old_logits = graphs.prefill(*calls["prefill"][1])
    with torch.no_grad():
        for dst, src in zip(lm_g.parameters(), lm_new.parameters()):
            dst.data = src.data
    graphs.refresh()
    check([t.data_ptr() for t in graphs.params["cells"][0].values()]
          == ptrs, "graphs: refresh() moved a captured parameter")
    fresh = PagedLMAdapter(lm_new, device=dev, graphs=False)
    fresh.setup(geom)
    got = graphs.prefill(*calls["prefill"][1])
    want = fresh.prefill(*calls["prefill"][1])
    refresh_diff, refresh_same = _graph_vs_eager(got, want,
                                                 "graphs after refresh()")
    check(not np.allclose(got, old_logits),
          "graphs: refresh() did not change the replayed logits")
    check(graphs.compiled == len(calls),
          "graphs: refresh() recaptured a graph")
    emit("graphs", families=list(calls), max_abs_logit_diff=worst,
         tolerance=f"{GRAPH_TOL} x max|logit|", bitwise_equal=bitwise,
         interleaved_replays_bitwise=True,
         traced_replay_kernel_records=records, compiled=graphs.compiled,
         programs=graphs.programs(), disk_hits=graphs.disk_hits,
         capture_ms={k[0]: p.capture_s * 1e3
                     for k, p in graphs._programs.items()},
         refresh_max_abs_logit_diff=refresh_diff,
         refresh_bitwise_equal=refresh_same)
    for a in (graphs, eager, fresh):
        a.teardown()


# ------------------------------------------------------------- profile
def _kernel_us(evt, torch):
    """Device microseconds of one averaged profiler entry if it is a
    device (kernel / memcpy / memset) entry, else None — CPU-op entries
    also carry their kernels' time and would count it twice."""
    if getattr(evt, "device_type", None) != torch.autograd.DeviceType.CUDA:
        return None
    for attr in ("device_time_total", "cuda_time_total"):
        v = getattr(evt, attr, None)
        if v is not None:
            return float(v)
    return None


KERNEL_NAMES = {"ragged_paged_attention": "ragged_paged_attention_kernel",
                "ragged_paged_verify": "ragged_paged_verify_kernel"}
# B1-B3: each tag matches both kernels of its wrapper (fp32:
# flash_bwd_dq_tf32_kernel; bf16: flash_bwd_dq_wgmma_kernel)
FLASH_NAMES = {"flash_attention_fwd": "flash_fwd_",
               "flash_attention_bwd_dq": "flash_bwd_dq_",
               "flash_attention_bwd_dkv": "flash_bwd_dkv_"}


# The tracer keeps a device record only if its start and end, converted
# to the host's clock, fall inside the window between the host's start
# and stop calls.  On the H100 the converted device times can stand past
# the host's own after a synchronize, and a trace stopped right after one
# has lost the last kernels of its final decode replay (``serve_trace``
# once found 8 of its 12 B4 records missing;
# ``mxnet_tpu_torch/tools/trace_window_probe.py`` repeats that trace with
# and without the padding).  So every trace starts and stops on an idle
# device.
TRACE_PAD_S = 0.2


# A trace's first graph launch can also lose the records of its first
# kernels.  In one run of this script the first of ``artifact_trace``'s
# 10 bucket-16 replays held 359 device records against 371 for each of
# the other nine (the 12 missing are the graph's first kernels: the
# embedding gathers, copies, the first LayerNorm and GEMM), twice in a
# row, and the training graph's first traced launch 1795 against 1797;
# a longer head takes B1 with it (another run found 239 of
# ``replicas_trace``'s 240 B1 records).  535 such traces in a fresh
# process (``trace_window_probe.py --bucket16``) lost nothing, so the
# cause lies in the state of a long run and is not known.  So a trace
# that counts graph replays starts with a warm-up: ``warm()`` launches
# each graph once inside the trace, the device is synchronised and left
# idle for ``WARM_GAP_S`` under a ``WARM_MARK`` host range, and the
# records before the middle of that range are not counted (the device
# and host clocks of a trace agree to a few milliseconds).
WARM_MARK = "chip_smoke.warm_up"
WARM_GAP_S = 0.05
# each warmed trace's device records per graph launch, warm-up apart:
# the ``trace_launches`` line
TRACE_LAUNCHES = []


@contextlib.contextmanager
def _profiled(torch, warm=None, where=None):
    """``torch.profiler`` over the block (CPU and CUDA activities), with
    the device synchronised and then left idle for ``TRACE_PAD_S`` after
    the trace starts and before it stops, so that no kernel of the block
    falls outside the tracer's window.  With ``warm``, the warm-up above
    runs first and the block gets the trace less the warm-up's records
    (``_Counted``); its launches go into ``TRACE_LAUNCHES`` as ``where``."""
    from torch.profiler import ProfilerActivity, profile, record_function
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        torch.cuda.synchronize()
        time.sleep(TRACE_PAD_S)
        if warm is not None:
            warm()
            torch.cuda.synchronize()
            with record_function(WARM_MARK):
                time.sleep(WARM_GAP_S)
        counted = prof if warm is None else _Counted(torch, prof)
        yield counted
        torch.cuda.synchronize()
        time.sleep(TRACE_PAD_S)
    if warm is not None:
        TRACE_LAUNCHES.append(dict(where=where, **counted.launch_records()))


class _Counted:
    """A warmed trace (``_profiled``) less its warm-up: ``events()`` and
    ``key_averages()`` as the profiler's, over the records that start
    after the middle of the ``WARM_MARK`` range."""

    def __init__(self, torch, prof):
        self._torch, self._prof, self._events = torch, prof, None

    def _split(self):
        mark = next(e for e in self._prof.events() if e.name == WARM_MARK)
        return (mark.time_range.start + mark.time_range.end) / 2

    def events(self):
        if self._events is None:
            from torch.autograd.profiler_util import EventList
            at = self._split()
            self._events = EventList(
                [e for e in self._prof.events() if e.time_range.start > at],
                use_device="cuda")
            # the events keep the parent links the whole trace's tree gave
            # them, which is what ``key_averages`` asks to have been built
            self._events._tree_built = True
        return self._events

    def key_averages(self):
        return self.events().key_averages()

    def launch_records(self):
        """The device records of each graph launch (by the correlation
        id a replay's kernels share with its ``cudaGraphLaunch``), for
        the warm-up's launches and the counted ones."""
        at, cuda = self._split(), self._torch.autograd.DeviceType.CUDA
        launches, records = [], collections.Counter()
        for e in self._prof.events():
            if getattr(e, "device_type", None) == cuda:
                records[e.id] += 1
            elif "GraphLaunch" in e.name:
                launches.append((e.time_range.start > at, e.id))
        return dict(warm_up=[records[c] for late, c in launches if not late],
                    counted=[records[c] for late, c in launches if late])


def _count_records(torch, prof, names):
    """How many times each kernel of ``names`` (wrapper -> kernel name
    tag) ran in a trace, from its kernel records."""
    counts = dict.fromkeys(names, 0)
    for evt in prof.key_averages():
        if _kernel_us(evt, torch) is None:
            continue
        for name, kernel in names.items():
            if kernel in evt.key:
                counts[name] += evt.count
    return counts


def _kernel_records(torch, run, names=KERNEL_NAMES, warm=None, where=None):
    """``run()`` traced with ``torch.profiler`` (after ``warm()``, whose
    records are not counted, when given): how many times each kernel of
    ``names`` (wrapper -> kernel name tag; B4's and B5's by default) ran
    on the card, from the trace's kernel records (launched by a wrapper
    or replayed by a CUDA graph alike)."""
    with _profiled(torch, warm, where) as prof:
        run()
    return _count_records(torch, prof, names)


def _decode_batch(geom):
    """The profile phase's decode batch (``PROFILE_POSITIONS``): tokens,
    positions and block tables over pages 1.., and the next free page."""
    positions = np.asarray(PROFILE_POSITIONS, np.int32)
    tables = np.zeros((MAX_BATCH, geom.pages_per_seq), np.int32)
    nxt = 1
    for b, p in enumerate(positions):
        n = geom.pages_for(int(p) + 1)
        tables[b, :n] = np.arange(nxt, nxt + n)
        nxt += n
    tokens = np.arange(1, MAX_BATCH + 1, dtype=np.int32)
    return tokens, positions, tables, nxt


def _is_host_call(key):
    """A CUDA API call (``cuda*`` or ``cu*``) that puts work on a
    stream: a kernel or graph launch, or a copy."""
    return key.startswith("cu") and ("Launch" in key or "Memcpy" in key)


def _kernel_sequence(torch, prof):
    """The kernel records of a trace (copies and sets left out) in the
    order they started: [(kernel name, device us)]."""
    cuda = torch.autograd.DeviceType.CUDA
    recs = sorted((e.time_range.start, e.name, e.time_range.elapsed_us())
                  for e in prof.events()
                  if getattr(e, "device_type", None) == cuda
                  and not any(t in e.name.lower()
                              for t in ("memcpy", "memset")))
    return [(name, us) for _t, name, us in recs]


def _runs_of(seq, tail):
    """The runs of ``tail`` (kernel names in order) in ``seq``
    (``_kernel_sequence``), non-overlapping, found from the end: (how
    many, their device us)."""
    k, i, runs, us = len(tail), len(seq) - len(tail), 0, 0.0
    while k and i >= 0:
        if all(seq[i + j][0] == tail[j] for j in range(k)):
            runs += 1
            us += sum(u for _n, u in seq[i:i + k])
            i -= k
        else:
            i -= 1
    return runs, us


def _trace_steps(torch, step, n, step_ms, warm=None, where=None,
                 names=None, tail=None):
    """``n`` calls of ``step`` traced with ``torch.profiler`` (after
    ``warm()``, whose records are not counted, when given:
    ``_profiled``): device time by kernel family (copies count under
    ``other`` and are also given alone), kernels and copies per step,
    host calls (launches, graph launches and copies) per step, and the
    device idle share against the untraced ``step_ms``; with ``names``
    (wrapper -> kernel name tag), each one's kernel records and device
    ms per step; with ``tail`` (kernel names in order), how many runs of
    that sequence the trace holds and their device ms per step."""
    with _profiled(torch, warm, where) as prof:
        t0 = time.perf_counter()
        for _ in range(n):
            step()
        torch.cuda.synchronize()
        profiled_ms = (time.perf_counter() - t0) / n * 1e3
    split = {"ragged_paged_attention": 0.0, "gemm": 0.0, "other": 0.0}
    kernels, host_calls, copy_us, top = 0, 0, 0.0, []
    records = dict.fromkeys(names or (), 0)
    name_us = dict.fromkeys(names or (), 0.0)
    for evt in prof.key_averages():
        us = _kernel_us(evt, torch)
        if not us:
            if _is_host_call(evt.key):
                host_calls += evt.count
            continue
        key = evt.key.lower()
        kernels += evt.count
        for name in records:
            if names[name] in evt.key:
                records[name] += evt.count
                name_us[name] += us
        if "memcpy" in key:
            copy_us += us
        top.append((us, evt.count, evt.key[:90]))
        if "ragged_paged_attention" in key:
            split["ragged_paged_attention"] += us
        elif any(t in key for t in GEMM_TAGS):
            split["gemm"] += us
        else:
            split["other"] += us
    busy_us = sum(split.values())
    top = [dict(kernel=k, ms_per_step=us / n / 1e3, launches_per_step=c / n)
           for us, c, k in sorted(top, reverse=True)[:8]]
    busy_ms = busy_us / n / 1e3
    # the idle share is taken against the UNPROFILED step: tracing
    # stretches the host's wall time, not the kernels' device time
    out = dict(
        step_ms_host=step_ms, step_ms_host_profiled=profiled_ms,
        device_ms_per_step=busy_ms if busy_us else None,
        device_ms_per_step_by_family={k: v / n / 1e3
                                      for k, v in split.items()}
        if busy_us else None,
        device_idle_share=(1.0 - busy_ms / step_ms) if busy_us else None,
        kernel_launches_per_step=kernels / n if busy_us else None,
        copy_ms_per_step=copy_us / n / 1e3,
        host_calls_per_step=host_calls / n, top_kernels=top)
    if names:
        out["records_per_step"] = {k: v / n for k, v in records.items()}
        out["device_ms_per_step_by_name"] = {k: v / n / 1e3
                                             for k, v in name_us.items()}
    if tail:
        runs, us = _runs_of(_kernel_sequence(torch, prof), tail)
        out["tail_runs"], out["tail_device_ms_per_step"] = runs, us / n / 1e3
    return out


def phase_profile(torch, dev, lm):
    """Where one decode step's time goes: ``PagedLMAdapter.decode_step``
    (numpy in, numpy out, as the engine calls it) at the serving batch of
    8 over mixed contexts, replaying its CUDA graph (``graphs``) and
    launching every kernel from Python (``eager``, ``graphs=False``):
    host-timed in turns (eager, graphs, graphs, eager), then each traced
    with ``torch.profiler`` and its device time split by kernel family."""
    from mxnet_tpu_torch.serving import PagedLMAdapter
    from mxnet_tpu_torch.serving.kv_cache import PageGeometry
    geom = PageGeometry(PAGE_SIZE, POOL_PAGES, lm.max_context,
                        lm.num_layers, lm.num_heads, lm.head_dim)
    tokens, positions, tables, _ = _decode_batch(geom)
    modes = ("eager", "graphs")
    adapters = {m: PagedLMAdapter(lm, device=dev, graphs=m == "graphs")
                for m in modes}
    steps = {}
    for m, adapter in adapters.items():
        adapter.setup(geom)
        steps[m] = functools.partial(adapter.decode_step, tokens, positions,
                                     tables)
        for _ in range(3):
            steps[m]()
    n = 20
    host = {m: [] for m in modes}
    for m in modes + modes[::-1]:
        t0 = time.perf_counter()
        for _ in range(n):
            steps[m]()
        host[m].append((time.perf_counter() - t0) / n * 1e3)
    rows = {m: _trace_steps(torch, steps[m], n, float(np.mean(host[m])))
            for m in modes}
    for m in modes:
        rows[m]["step_ms_host_turns"] = host[m]
        adapters[m].teardown()
    emit("profile", batch=MAX_BATCH, positions=positions.tolist(), **rows)


# ----------------------------------------------------------------- serve
def _run_wave(generate, prompts):
    """Every prompt of ``prompts`` generated at once through
    ``generate`` (a ``DecodeEngine.generate``, or ``ModelServer.generate``
    bound to a model), one thread each: [(prompt, tokens, ttft
    seconds)] and the wave's wall seconds."""
    out = [None] * len(prompts)

    def one(i):
        t0 = time.perf_counter()
        first = []
        toks = generate(
            prompts[i], max_new_tokens=32, timeout=600,
            on_token=lambda _t: first or first.append(time.perf_counter()))
        out[i] = (prompts[i], toks, first[0] - t0)

    ts = [threading.Thread(target=one, args=(i,), daemon=True)
          for i in range(len(prompts))]
    t0 = time.perf_counter()
    for t in ts:
        t.start()
    for t in ts:
        t.join(900)
    check(not any(t.is_alive() for t in ts), "a request hung")
    check(all(o is not None for o in out), "a request failed")
    return out, time.perf_counter() - t0


def _serve_traffic(lm):
    """The served configuration and traffic: a warm-up prompt, then 8
    prompts of 17-511 tokens at once, one request seeding a 256-token
    prefix, and 3 requests hitting it (``RandomState(2)``)."""
    from mxnet_tpu_torch.serving import ServingConfig
    cfg = ServingConfig(decode_page_size=PAGE_SIZE,
                        decode_pool_pages=POOL_PAGES,
                        decode_max_batch=MAX_BATCH, prefix_cache=True,
                        decode_max_new_tokens=32)
    rs = np.random.RandomState(2)
    V = lm.vocab_size
    warm = rs.randint(0, V, 8)
    lens = rs.randint(17, 512, MAX_BATCH)
    wave1 = [rs.randint(0, V, n) for n in lens]
    prefix = rs.randint(0, V, 256)
    seed_req = np.concatenate([prefix, rs.randint(0, V, 16)])
    wave3 = [np.concatenate([prefix, rs.randint(0, V, 5)]),
             np.concatenate([prefix, rs.randint(0, V, 37)]),
             seed_req]
    return cfg, warm, (wave1, [seed_req], wave3)


def _pool_bytes(torch, pool):
    """Bytes allocated (live blocks) in the segments of CUDA-graph memory
    pool ``pool``, from ``torch.cuda.memory_snapshot()``."""
    if pool is None:
        return 0
    return sum(seg["allocated_size"] for seg in torch.cuda.memory_snapshot()
               if tuple(seg.get("segment_pool_id", ())) == tuple(pool))


def _measure_warm(torch, adapter):
    """Wrap ``adapter.warm`` (which the engine calls when it binds the
    adapter, after ``setup``) so that it records
    ``torch.cuda.memory_allocated`` before and after it, and how much of
    the rise is live in the adapter's graph pool.  Returns the dict it
    fills."""
    out, warm = {}, adapter.warm

    def measured(signatures):
        torch.cuda.synchronize()
        before = torch.cuda.memory_allocated()
        warm(signatures)
        torch.cuda.synchronize()
        after = torch.cuda.memory_allocated()
        out.update(allocated_before_gb=before / 1e9,
                   allocated_after_gb=after / 1e9,
                   rise_gb=(after - before) / 1e9,
                   graph_pool_gb=_pool_bytes(torch, adapter._graph_pool)
                   / 1e9, signatures=len(signatures))

    adapter.warm = measured
    return out


def phase_serve(torch, dev, lm):
    """Threaded ``DecodeEngine.generate`` through the adapter's CUDA
    graphs (the default), every one captured when the engine binds the
    adapter.  The B4/B5 counters are zeroed just before the engine is
    built and read after the waves: they count the wrappers' eager
    launches (the captures' warm-up runs); ``phase_serve_trace`` counts
    the replayed kernels.  Then the same prompts through an eager
    (``graphs=False``) engine, whose tokens are compared (reported, not
    asserted)."""
    from mxnet_tpu_torch.ops import paged_attention as pa
    from mxnet_tpu_torch.serving import DecodeEngine, PagedLMAdapter
    cfg, warm, waves = _serve_traffic(lm)
    pa.ragged_paged_attention.launches = 0
    pa.ragged_paged_verify.launches = 0
    adapter = PagedLMAdapter(lm, device="cuda")
    warm_memory = _measure_warm(torch, adapter)
    t0 = time.perf_counter()
    eng = DecodeEngine(adapter, cfg, model_name="gpt2-small",
                       autostart=True)
    bind_s = time.perf_counter() - t0
    check(warm_memory, "serve: the engine did not warm the adapter")
    check(adapter.compiled == len(eng.signatures()),
          f"serve: {adapter.compiled} graphs captured at bind, not "
          f"{len(eng.signatures())}")
    V = lm.vocab_size
    results = []
    try:
        # warm-up: a sub-page prompt (nothing enters the prefix cache)
        eng.generate(warm, max_new_tokens=4, timeout=600)
        (out1, s1), (out2, s2), (out3, s3) = [_run_wave(eng.generate, w)
                                              for w in waves]
        launches = {"ragged_paged_attention":
                    pa.ragged_paged_attention.launches,
                    "ragged_paged_verify": pa.ragged_paged_verify.launches}
        check(all(launches.values()),
              f"a kernel of the served path never launched: {launches}")
        results = out1 + out2 + out3
        for prompt, toks, _ in results:
            check(len(toks) == 32 and 0 <= int(toks.min())
                  and int(toks.max()) < V,
                  "generate returned a wrong token array")
        st = eng.stats()
        check(st["prefix_hits"] == 3, f"expected 3 prefix hits: {st}")
        check(st["programs"] <= st["program_bound"],
              f"programs {st['programs']} > bound {st['program_bound']}")
    finally:
        stopped = eng.stop(timeout=120)
    check(stopped, "engine did not stop")
    check(eng.allocator.used_pages == 0,
          f"{eng.allocator.used_pages} pages still held after drain")
    eng.allocator.check_leaks()
    # the same waves through an eager engine (reported: the graphs run the
    # same kernels, so the tokens are expected to agree)
    eager = DecodeEngine(PagedLMAdapter(lm, device="cuda", graphs=False),
                         cfg, model_name="gpt2-small-eager", autostart=True)
    try:
        eager.generate(warm, max_new_tokens=4, timeout=600)
        eager_out = [o for w in waves
                     for o in _run_wave(eager.generate, w)[0]]
    finally:
        check(eager.stop(timeout=120), "eager engine did not stop")
    same = sum(int((a[1] == b[1]).sum()) for a, b in zip(results,
                                                         eager_out))
    # greedy tokens vs the dense forward's argmax (reported: random
    # weights make near-ties, so a flip is not a failure)
    agree = total = 0
    with torch.no_grad():
        for prompt, toks, _ in results:
            seq = np.concatenate([prompt, toks[:-1]]).astype(np.int64)
            full = lm(torch.from_numpy(seq)[None].to(dev))[0]
            ref = full[len(prompt) - 1:].argmax(-1).cpu().numpy()
            agree += int((ref == toks).sum())
            total += len(toks)
    ttft = sorted(r[2] for r in results)
    gen = sum(len(r[1]) for r in results)
    emit("serve", requests=len(results), generated_tokens=gen,
         wall_s=s1 + s2 + s3,
         tokens_per_s=gen / (s1 + s2 + s3),
         wave_tokens_per_s=[len(out1) * 32 / s1, 32 / s2,
                            len(out3) * 32 / s3],
         ttft_p50_s=float(np.median(ttft)), ttft_max_s=ttft[-1],
         prompt_lens=[len(r[0]) for r in results],
         prefix_hits=st["prefix_hits"], prefix_misses=st["prefix_misses"],
         prefix_tokens_saved=st["prefix_tokens_saved"],
         programs=st["programs"], program_bound=st["program_bound"],
         compiled=adapter.compiled, disk_hits=adapter.disk_hits,
         bind_s=bind_s, capture_s=adapter.capture_seconds,
         warm_memory=warm_memory,
         used_pages_after_drain=eng.allocator.used_pages,
         kernel_launches=launches,
         tokens_equal_to_eager_engine=same / total,
         greedy_vs_full_forward_argmax=agree / total)
    return launches, dict(warm=warm, waves=waves, results=results)


def phase_serve_trace(torch, lm):
    """The ``serve`` phase's traffic again, on a new engine (its graphs
    captured at bind), traced with ``torch.profiler`` after a warm-up
    request in the trace: every call replays a graph, so the B4/B5
    wrappers count nothing, and the trace's kernel records equal
    ``num_layers`` per decode / verify replay.  Returns the records.  It runs after the training phases:
    the profiler's device tracing slows every later launch."""
    from mxnet_tpu_torch.ops import paged_attention as pa
    from mxnet_tpu_torch.serving import DecodeEngine, PagedLMAdapter
    cfg, warm, waves = _serve_traffic(lm)
    adapter = PagedLMAdapter(lm, device="cuda")
    eng = DecodeEngine(adapter, cfg, model_name="gpt2-small-traced",
                       autostart=True)
    kernels = (pa.ragged_paged_attention, pa.ragged_paged_verify)
    try:
        eng.generate(warm, max_new_tokens=4, timeout=600)
        counted = [w.launches for w in kernels]
        take = {}

        def traced():
            take["replays"] = {k: p.replays
                               for k, p in adapter._programs.items()}
            for w in waves:
                _run_wave(eng.generate, w)

        records = _kernel_records(
            torch, traced, where="serve_trace",
            warm=lambda: eng.generate(warm, max_new_tokens=4, timeout=600))
        ran = {k: p.replays - take["replays"][k]
               for k, p in adapter._programs.items()}
    finally:
        check(eng.stop(timeout=120), "traced engine did not stop")
    L = lm.num_layers
    want = {"ragged_paged_attention": L * sum(
                n for k, n in ran.items() if k[0] == "decode"),
            "ragged_paged_verify": L * sum(
                n for k, n in ran.items()
                if k[0] in ("verify", "verify_batch"))}
    check(records == want and all(want.values()),
          f"serve_trace: the traced waves ran {records} B4/B5 kernels; "
          f"their graph replays hold {want}")
    check(counted == [w.launches for w in kernels],
          "serve_trace: a wrapper launched outside a graph")
    emit("serve_trace", kernel_records=records,
         replays={"/".join(map(str, k)): n for k, n in ran.items() if n})
    return records


# --------------------------------------------------------------- predict
def _predict_traffic(vocab):
    """Sentence-pair classification traffic (``RandomState(0)``): 8
    clients of 12 requests each, rows per request from {1, 2, 3, 5},
    valid lengths 16-128, the second segment from half the valid length
    on.  Tokens, segments and lengths are int32, as served."""
    rs = np.random.RandomState(0)
    L = PREDICT_L
    clients = []
    for _ in range(PREDICT_CLIENTS):
        reqs = []
        for _ in range(PREDICT_REQUESTS):
            n = int(rs.choice(PREDICT_ROWS))
            valid = rs.randint(16, L + 1, n).astype(np.int32)
            tokens = rs.randint(0, vocab, (n, L)).astype(np.int32)
            types = (np.arange(L)[None] >= valid[:, None] // 2).astype(
                np.int32)
            reqs.append((tokens, types, valid))
        clients.append(reqs)
    return clients


def _bert_classifier(torch, dev, seed, use_flash=True):
    from mxnet_tpu_torch.models import torch_bert as models
    bert = models.bert_24_1024_16(
        use_flash=use_flash, dropout=0.0, device=dev,
        generator=torch.Generator().manual_seed(seed))
    return models.BERTClassifier(bert, num_classes=2).eval()


def _eager_logits(torch, dev, model, clients):
    """``model``'s eager forward on each request alone."""
    with torch.no_grad():
        out = [[model(*(torch.from_numpy(a).to(dev) for a in req))
                .cpu().numpy() for req in reqs] for reqs in clients]
    torch.cuda.synchronize()
    return out


def _run_clients(srv, clients, gate=None, on_done=None):
    """Every client's requests in order through ``srv.predict``, one
    thread per client, all at once.  With ``gate`` (an Event) each
    client sends the first half of its requests, waits for the gate,
    then the rest.  Returns [[(logits, t_start, t_end)] per client] and
    the wall seconds."""
    out = [[None] * len(c) for c in clients]
    errors = []

    def client(ci):
        try:
            for k, req in enumerate(clients[ci]):
                if gate is not None and k == len(clients[ci]) // 2:
                    check(gate.wait(600), "predict: the swap never came")
                t0 = time.perf_counter()
                y = srv.predict("bert", *req, timeout=600)
                out[ci][k] = (y, t0, time.perf_counter())
                if on_done is not None:
                    on_done()
        except Exception as e:          # noqa: BLE001 — reported below
            errors.append(e)

    ts = [threading.Thread(target=client, args=(i,), daemon=True)
          for i in range(len(clients))]
    t0 = time.perf_counter()
    for t in ts:
        t.start()
    for t in ts:
        t.join(900)
    check(not any(t.is_alive() for t in ts), "predict: a client hung")
    check(not errors, f"predict: a request failed: {errors[:1]}")
    return out, time.perf_counter() - t0


def _predict_err(got, want):
    """Largest |served - reference| over the traffic, and the traffic's
    max |logit| (the scale the tolerance is taken against)."""
    err = scale = 0.0
    for g_c, w_c in zip(got, want):
        for (g, *_), w in zip(g_c, w_c):
            check(g.shape == w.shape and np.isfinite(g).all(),
                  f"predict: response of shape {g.shape}, want {w.shape}")
            err = max(err, float(np.abs(g - w).max()))
            scale = max(scale, float(np.abs(w).max()))
    return err, scale


def _pool_reserved(torch, pool):
    """Bytes reserved (segment sizes) by CUDA-graph memory pool
    ``pool``."""
    if pool is None:
        return 0
    return sum(seg["total_size"] for seg in torch.cuda.memory_snapshot()
               if tuple(seg.get("segment_pool_id", ())) == tuple(pool))


def _entry_programs(srv, entry):
    """{bucket: program} of ``entry`` in the server's batcher cache."""
    with srv.batcher._lock:
        return {b: p for (uid, b), p in srv.batcher._progs.items()
                if uid == entry.uid}


def _hot_swap(srv, repo, clients, register_v2, want1, want2, tol, where):
    """``clients`` through ``srv`` on version 1 of "bert" while
    ``register_v2()`` registers version 2 (not active), ``srv.prewarm``
    builds it and ``repo.swap`` makes it current, once a sixth of the
    requests are done; each client sends its second half after the swap.
    Every response must match the version that admitted it (``want1`` /
    ``want2``, within ``tol``), both versions must have answered, and no
    bucket may be built after the swap.  Returns the counts."""
    n_req = sum(len(c) for c in clients)
    done, first_half = [0], threading.Event()
    lock = threading.Lock()

    def on_done():
        with lock:
            done[0] += 1
            if done[0] >= n_req // 6:
                first_half.set()

    swapped = threading.Event()
    result = {}

    def traffic():
        result["out"] = _run_clients(srv, clients, gate=swapped,
                                     on_done=on_done)

    runner = threading.Thread(target=traffic, daemon=True)
    runner.start()
    try:
        check(first_half.wait(600), f"{where}: the traffic never started")
        t_reg = time.perf_counter()
        register_v2()
        srv.prewarm("bert", version=2)
        misses_v2 = srv.stats()["bucket_misses"]
        t_swap0 = time.perf_counter()
        repo.swap("bert", 2)
        t_swap1 = time.perf_counter()
    finally:
        swapped.set()
        runner.join(900)
    check(not runner.is_alive() and "out" in result,
          f"{where}: the hot-swap traffic hung")
    versions, during_prewarm = {1: 0, 2: 0}, 0
    for g_c, w1_c, w2_c in zip(result["out"][0], want1, want2):
        for (y, ta, tb), w1, w2 in zip(g_c, w1_c, w2_c):
            ok1 = np.abs(y - w1).max() <= tol
            ok2 = np.abs(y - w2).max() <= tol
            check(ok1 or ok2, f"{where}: a response matches neither version")
            check(not (tb < t_swap0 and not ok1) and
                  not (ta > t_swap1 and not ok2),
                  f"{where}: a response does not match the version that "
                  f"admitted it")
            versions[1 if ok1 else 2] += 1
            during_prewarm += bool(ok1 and tb > t_reg)
    check(versions[1] and versions[2],
          f"{where}: the swap did not land mid-traffic: {versions}")
    check(srv.stats()["bucket_misses"] == misses_v2,
          f"{where}: a bucket was built after the swap")
    return {"responses_v1": versions[1], "responses_v2": versions[2],
            "v1_responses_after_register": during_prewarm,
            "register_to_swap_s": t_swap0 - t_reg}


def phase_predict(torch, dev, lm, served):
    """``ModelServer.predict`` on BERT-large: a ``BERTClassifier`` over
    ``bert_24_1024_16`` (fp32, random weights from seed 0, depth not
    cut) registered with ``ModelRepository.add_block`` at L = 128, one
    CUDA graph per batch bucket {1, 2, 4, 8, 16} (each holding 24 B1
    launches), captured by ``srv.prewarm`` before the traffic.  Then the
    same traffic with a hot swap to version 2 (seed 1) prewarmed under
    load, the unload of version 1, and ``ModelServer.generate`` on the
    GPT-2-small LM against the ``serve`` phase's tokens.  The B1/B4/B5
    counters are zeroed just before the server is built and read after
    ``generate``: they count the captures' eager warm-ups.  Returns
    what ``phase_predict_trace`` needs (the server stays up)."""
    from mxnet_tpu_torch import runtime_metrics as rm
    from mxnet_tpu_torch.ops import flash_attention as fa
    from mxnet_tpu_torch.ops import paged_attention as pa
    from mxnet_tpu_torch.serving import (ModelRepository, ModelServer,
                                         ServingConfig, bucket_set,
                                         pad_batch)
    t_phase = time.perf_counter()
    clients = _predict_traffic(BERT_LARGE["vocab_size"])
    rows = sum(r[0].shape[0] for c in clients for r in c)
    n_req = sum(len(c) for c in clients)
    clf = _bert_classifier(torch, dev, 0)
    dense = _bert_classifier(torch, dev, 0, use_flash=False)
    dense.load_state_dict(clf.state_dict())
    want1 = _eager_logits(torch, dev, clf, clients)
    want_dense = _eager_logits(torch, dev, dense, clients)
    del dense
    clf2 = _bert_classifier(torch, dev, 1)
    want2 = _eager_logits(torch, dev, clf2, clients)
    snap_bytes = sum(t.numel() * t.element_size() for t in
                     list(clf.parameters()) + list(clf.buffers()))

    L = PREDICT_L
    example = (np.zeros((1, L), np.int32), np.zeros((1, L), np.int32),
               np.full((1,), L, np.int32))
    cfg = ServingConfig(max_batch_size=PREDICT_MAX_BATCH,
                        num_workers=PREDICT_WORKERS, max_latency_us=2000,
                        decode_page_size=PAGE_SIZE,
                        decode_pool_pages=POOL_PAGES,
                        decode_max_batch=MAX_BATCH, prefix_cache=True,
                        decode_max_new_tokens=32)
    counters = (fa.flash_attention_fwd, pa.ragged_paged_attention,
                pa.ragged_paged_verify)
    for k in counters:
        k.launches = 0
    repo = ModelRepository()
    e1 = repo.add_block("bert", clf, *example)
    del clf                     # the served version lives in the snapshot
    _free(torch)
    srv = ModelServer(repo, cfg)
    torch.cuda.synchronize()
    mem0 = torch.cuda.memory_allocated(), torch.cuda.memory_reserved()
    t0 = time.perf_counter()
    warm = srv.prewarm("bert")
    prewarm_s = time.perf_counter() - t0
    torch.cuda.synchronize()
    mem1 = torch.cuda.memory_allocated(), torch.cuda.memory_reserved()
    progs = _entry_programs(srv, e1)
    check(sorted(progs) == bucket_set(PREDICT_MAX_BATCH)
          and warm["compiled"] == len(progs),
          f"predict: prewarm built {warm}")
    capture_s = {b: p.capture_s for b, p in sorted(progs.items())}
    pools = {"allocated_gb": sum(_pool_bytes(torch, p.pool)
                                 for p in progs.values()) / 1e9,
             "reserved_gb": sum(_pool_reserved(torch, p.pool)
                                for p in progs.values()) / 1e9}
    b1_built = fa.flash_attention_fwd.launches
    check(b1_built == 24 * len(progs),
          f"predict: {b1_built} B1 launches for {len(progs)} captures "
          f"(24 each: the eager warm-up before each capture)")
    del progs

    # window 1: the traffic on version 1, untraced, metrics on
    st0 = srv.stats()
    rm.reset()
    rm.enable()
    try:
        got, wall = _run_clients(srv, clients)
    finally:
        rm.disable()
    st1 = srv.stats()
    occupancy = rm.SERVING_BATCH_OCCUPANCY.sum() \
        / max(1, rm.SERVING_BATCH_OCCUPANCY.count())
    rm.reset()
    err_eager, scale = _predict_err(got, want1)
    err_dense, _ = _predict_err(got, want_dense)
    tol = PREDICT_TOL * scale
    check(err_eager <= tol and err_dense <= tol,
          f"predict: served logits differ from the eager forward by "
          f"{err_eager}, from the dense path by {err_dense} "
          f"(tolerance {tol})")
    batches = st1["batches"] - st0["batches"]
    check(batches < n_req, f"predict: {batches} batches for {n_req} "
                           f"requests: nothing coalesced")
    check(st1["programs"] <= len(bucket_set(PREDICT_MAX_BATCH)),
          f"predict: {st1['programs']} programs")
    check(st1["bucket_misses"] == st0["bucket_misses"],
          "predict: a bucket was built during the window after prewarm")
    lat = sorted(tb - ta for c in got for _y, ta, tb in c)

    # window 2: the same traffic, version 2 registered, prewarmed and
    # swapped in while version 1 serves the first half of every client
    holder = {}

    def register_v2():
        holder["e2"] = repo.add_block("bert", clf2, *example,
                                      activate=False)

    hot_swap = _hot_swap(srv, repo, clients, register_v2, want1, want2,
                         tol, "predict")
    e2 = holder.pop("e2")
    del clf2

    # unload version 1: its programs, pools and snapshot go
    gc.collect()
    torch.cuda.synchronize()
    before_unload = torch.cuda.memory_allocated()
    repo.unload("bert", 1)
    del e1
    gc.collect()
    torch.cuda.synchronize()
    freed = before_unload - torch.cuda.memory_allocated()
    check(freed >= snap_bytes,
          f"predict: unload freed {freed} bytes, less than the "
          f"snapshot's {snap_bytes}")

    # generate: the serve phase's waves through ModelServer.generate
    repo.add_decoder("lm", lm)
    gen = functools.partial(srv.generate, "lm")
    gen(served["warm"], max_new_tokens=4, timeout=600)
    t0 = time.perf_counter()
    gen_out = [o for w in served["waves"] for o in _run_wave(gen, w)[0]]
    gen_s = time.perf_counter() - t0
    check(len(gen_out) == len(served["results"]) and all(
        np.array_equal(a[1], b[1])
        for a, b in zip(gen_out, served["results"])),
        "predict: ModelServer.generate's tokens differ from the serve "
        "phase's DecodeEngine tokens")
    launches = {k.__name__: k.launches for k in counters}
    check(all(launches.values()),
          f"predict: a kernel of the path never launched: {launches}")
    dstats = srv.decode_stats("lm")

    # one bucket-16 batch, untraced (the trace phase takes its device
    # time): host ms per call of the program
    prog16 = srv.batcher.program_for(e2, PREDICT_MAX_BATCH)
    padded16, _ = pad_batch([r for c in clients for r in c][:6],
                            PREDICT_MAX_BATCH)
    for _ in range(3):
        prog16(*padded16)
    t0 = time.perf_counter()
    for _ in range(10):
        prog16(*padded16)
    host16_ms = (time.perf_counter() - t0) / 10 * 1e3
    emit("predict", requests=n_req, rows=rows, wall_s=wall,
         requests_per_s=n_req / wall, rows_per_s=rows / wall,
         latency_p50_ms=float(np.percentile(lat, 50)) * 1e3,
         latency_p99_ms=float(np.percentile(lat, 99)) * 1e3,
         batches=batches, mean_bucket_occupancy=occupancy,
         programs=st1["programs"], prewarm=warm, prewarm_s=prewarm_s,
         capture_s=capture_s,
         prewarm_memory={"allocated_gb": (mem1[0] - mem0[0]) / 1e9,
                         "reserved_gb": (mem1[1] - mem0[1]) / 1e9},
         graph_pools=pools, max_abs_err_vs_eager=err_eager,
         max_abs_err_vs_dense=err_dense, max_abs_logit=scale,
         tolerance=tol,
         hot_swap=hot_swap,
         unload_freed_gb=freed / 1e9, snapshot_gb=snap_bytes / 1e9,
         generate={"requests": len(gen_out), "wall_s": gen_s,
                   "tokens_equal_to_serve": True,
                   "programs": dstats["programs"],
                   "program_bound": dstats["program_bound"]},
         bucket16_host_ms=host16_ms, kernel_launches=launches,
         seconds=time.perf_counter() - t_phase)
    return dict(srv=srv, clients=clients, want=want2, tol=tol,
                wall_s=wall, prog16=prog16, padded16=padded16,
                host16_ms=host16_ms, launches=launches,
                latency_p99_ms=float(np.percentile(lat, 99)) * 1e3)


def _busy_union_us(torch, prof):
    """Microseconds during which at least one device record of ``prof``
    ran: the union of their intervals (kernels of concurrent streams
    overlap, so their durations' sum overstates the busy time)."""
    spans = sorted((e.time_range.start, e.time_range.end)
                   for e in prof.events()
                   if getattr(e, "device_type", None)
                   == torch.autograd.DeviceType.CUDA)
    busy, cur = 0.0, None
    for s, e in spans:
        if cur is None or s > cur[1]:
            if cur is not None:
                busy += cur[1] - cur[0]
            cur = [s, e]
        else:
            cur[1] = max(cur[1], e)
    return busy + (cur[1] - cur[0] if cur is not None else 0.0)


def phase_predict_trace(torch, ctx):
    """The ``predict`` phase's traffic again, on version 2 (every bucket
    prewarmed), traced with ``torch.profiler`` after a warm-up replay of
    each bucket: every batch replays a graph, so the B1 wrapper counts
    nothing and the trace holds exactly
    24 B1 kernel records per executed batch.  Also traces 10 calls of
    the bucket-16 program alone for its device time.  The window's idle
    share is taken against its own (traced) wall time, from the union of
    its device records' intervals: the workers' batches run on their
    programs' streams side by side.  Then stops the server.  Returns the
    B1 records and the batches they ran in."""
    from mxnet_tpu_torch.ops import flash_attention as fa
    from mxnet_tpu_torch.serving import pad_batch
    srv = ctx["srv"]
    entry = srv.repository.get("bert")
    try:
        progs = _entry_programs(srv, entry)
        counted = fa.flash_attention_fwd.launches
        b1 = FLASH_NAMES["flash_attention_fwd"]
        one_row = tuple(a[:1] for a in ctx["clients"][0][0])
        holder = {}

        def warm():
            for p in progs.values():
                p(*pad_batch([one_row], p.rows)[0])

        with _profiled(torch, warm=warm, where="predict_trace") as prof:
            replays = {b: p.replays for b, p in progs.items()}
            holder["out"] = _run_clients(srv, ctx["clients"])
        ran = sum(p.replays - replays[b] for b, p in progs.items())
        records = 0
        busy_us = 0.0
        for evt in prof.key_averages():
            us = _kernel_us(evt, torch)
            if us is None:
                continue
            busy_us += us
            if b1 in evt.key:
                records += evt.count
        check(records == 24 * ran and ran,
              f"predict_trace: {records} B1 records for {ran} replayed "
              f"batches (24 each)")
        check(fa.flash_attention_fwd.launches == counted,
              "predict_trace: B1 launched outside a graph")
        busy_ms = _busy_union_us(torch, prof) / 1e3
        check(busy_ms > 0, "predict_trace: no device record in the "
                           "traced window")
        err, _ = _predict_err(holder["out"][0], ctx["want"])
        check(err <= ctx["tol"],
              f"predict_trace: traced responses off by {err}")
        prog16 = ctx["prog16"]
        step = functools.partial(prog16, *ctx["padded16"])
        b16 = _trace_steps(torch, step, 10, ctx["host16_ms"])
    finally:
        check(srv.stop(timeout=120), "predict: the server did not stop")
    traced_ms = holder["out"][1] * 1e3
    emit("predict_trace", batches=ran, b1_kernel_records=records,
         device_busy_ms=busy_ms, device_record_ms_sum=busy_us / 1e3,
         traced_wall_ms=traced_ms,
         device_idle_share=1.0 - busy_ms / traced_ms,
         untraced_wall_ms=ctx["wall_s"] * 1e3,
         bucket16=dict(device_ms=b16["device_ms_per_step"],
                       host_ms=b16["step_ms_host"],
                       device_idle_share=b16["device_idle_share"],
                       kernels=b16["kernel_launches_per_step"],
                       host_calls=b16["host_calls_per_step"],
                       by_family=b16["device_ms_per_step_by_family"]))
    return {"records": records, "batches": ran}


# ------------------------------------------------------------- replicas
# the replicas phase: Predict's configuration and traffic through
# ServingConfig(replicas=2) (two replicas sharing the card and the weight
# snapshot), the serve configuration's decode path with replicas=2
REPLICAS = 2
# a failed-over batch against the replicas=1 twin's program on the same
# padded inputs: the same kernels on the same data (bit for bit expected,
# reported); held to 1e-5 of max|logit| in case the library picks another
# GEMM algorithm for a capture stream
REPLICA_TWIN_TOL = 1e-5
# r0's stalled heartbeat: three heartbeat windows (default 500 ms)
REPLICA_STALL_MS = 1500
# the decode failover: decode steps that succeed before r0's step site
# fails; three firings exhaust its two retries (MXNET_SERVING_RETRY_MAX)
# and quarantine the sequence
REPLICA_DECODE_FAIL = "replica.r0.decode.step=fail,after=4,times=3"


def _replica_traffic(srv, clients, want, tol, stop, where):
    """Predict's clients through ``srv`` pass after pass until ``stop``
    is set (at least one pass), on a thread; returns (thread, record):
    the record gets the passes, the responses and the first error, and
    every response is held to ``want`` within ``tol``."""
    rec = {"passes": 0, "responses": 0, "max_abs_err": 0.0, "error": None}

    def run():
        try:
            while True:
                got, _ = _run_clients(srv, clients)
                err, _ = _predict_err(got, want)
                check(err <= tol, f"{where}: a response off by {err} "
                                  f"(tolerance {tol})")
                rec["passes"] += 1
                rec["responses"] += sum(len(c) for c in got)
                rec["max_abs_err"] = max(rec["max_abs_err"], err)
                if stop.is_set():
                    return
        except Exception as e:          # noqa: BLE001 — checked by caller
            rec["error"] = e

    t = threading.Thread(target=run, daemon=True)
    t.start()
    return t, rec


def _join_traffic(t, rec, where):
    t.join(900)
    check(not t.is_alive(), f"{where}: the traffic hung")
    check(rec["error"] is None, f"{where}: {rec['error']}")
    return {k: rec[k] for k in ("passes", "responses", "max_abs_err")}


def _wait_for(cond, timeout, where):
    t0 = time.perf_counter()
    while not cond():
        check(time.perf_counter() - t0 < timeout, f"{where}: timed out")
        time.sleep(0.005)
    return time.perf_counter() - t0


def _fill_bucket(clients, rows):
    """The first requests of the traffic that fit in ``rows`` rows."""
    out, n = [], 0
    for req in (r for c in clients for r in c):
        if n + req[0].shape[0] <= rows:
            out.append(req)
            n += req[0].shape[0]
    return out


def _replica_captures(torch, rset, entry):
    """Capture seconds and graph-pool bytes of each predict replica's
    programs."""
    out = {}
    for rid in rset.replicas():
        rep = rset.replica(rid)
        progs = rep.batcher.program_list(entry)
        out[rid] = dict(
            programs=len(progs), capture_s=rep.capture_seconds(),
            bringup_s=rep.bringup_s,
            pool_allocated_gb=sum(_pool_bytes(torch, p.pool)
                                  for p in progs) / 1e9,
            pool_reserved_gb=sum(_pool_reserved(torch, p.pool)
                                 for p in progs) / 1e9)
    return out


def _twin_failover(rset, one, entry, batch, scale):
    """``batch`` through the replica set with the first replica's
    dispatch failing (``replica.*.execute``, once), against the
    replicas=1 server's program on the same batch."""
    from mxnet_tpu_torch import faults
    from mxnet_tpu_torch.serving.resilience import Deadline
    ref = one.batcher.run_batch(entry, batch)
    before = rset.stats()["failovers"]
    with faults.plan("replica.*.execute=fail,times=1"):
        got = rset.run_batch(batch, deadline=Deadline.start(600))
    check(rset.stats()["failovers"] == before + 1,
          "replicas: the twin batch did not fail over")
    err = max(float(np.abs(g[0] - r[0]).max()) for g, r in zip(got, ref))
    check(err <= REPLICA_TWIN_TOL * scale,
          f"replicas: a failed-over batch is {err} off the replicas=1 "
          f"twin (tolerance {REPLICA_TWIN_TOL * scale})")
    return dict(rows=sum(r[0].shape[0] for r in batch), max_abs_err=err,
                bitwise_equal=all(np.array_equal(g[0], r[0])
                                  for g, r in zip(got, ref)))


def _clone_bytes(torch, adapter, lm):
    """Bytes of ``adapter``'s parameters that do not share storage with
    the LM's own tensors."""
    from mxnet_tpu_torch.serving.decode import _param_items
    own = {t.untyped_storage().data_ptr() for t in
           list(lm.parameters()) + list(lm.buffers())}
    return sum(t.numel() * t.element_size()
               for _, t in _param_items(adapter.params)
               if t.untyped_storage().data_ptr() not in own)


def _replica_decode(torch, dev, lm, served):
    """The serve configuration's decode path through
    ``ModelServer(replicas=2).generate``: each replica a
    ``PagedLMAdapter`` clone over the one LM (its own KV pool, graphs and
    stream), its graphs captured when its engine binds it.  The serve
    phase's waves must give the serve phase's tokens; a decode step that
    fails on r0 mid-generation must quarantine the sequence and fail it
    over to r1 with the same tokens; no page may leak."""
    from mxnet_tpu_torch import faults
    from mxnet_tpu_torch.serving import (ModelRepository, ModelServer,
                                         ServingConfig)
    cfg = ServingConfig(decode_page_size=PAGE_SIZE,
                        decode_pool_pages=POOL_PAGES,
                        decode_max_batch=MAX_BATCH, prefix_cache=True,
                        decode_max_new_tokens=32, replicas=REPLICAS)
    repo = ModelRepository()
    repo.add_decoder("lm", lm)
    srv = ModelServer(repo, cfg)
    t0 = time.perf_counter()
    srv.prewarm("lm")
    bind_s = time.perf_counter() - t0
    rset = srv.replica_set("lm")
    adapters = {rid: rset.replica(rid).engine.model
                for rid in rset.replicas()}
    check(len({id(a) for a in adapters.values()}) == REPLICAS
          and all(a is not repo.get("lm").decode_model
                  for a in adapters.values()),
          "replicas: the decode replicas share an adapter")
    per = {}
    for rid, a in adapters.items():
        eng = rset.replica(rid).engine
        dec = a._programs.get(("decode", MAX_BATCH))
        check(a.compiled == len(eng.signatures()) and dec is not None
              and dec.graph is not None,
              f"replicas: {rid} captured {a.compiled} graphs, not "
              f"{len(eng.signatures())} with its decode graph")
        per[rid] = dict(
            graphs=a.compiled, capture_s=a.capture_seconds,
            clone_param_bytes=_clone_bytes(torch, a, lm),
            kv_pool_gb=(a.pool.k_pages.numel() * a.pool.k_pages.element_size()
                        + a.pool.v_pages.numel()
                        * a.pool.v_pages.element_size()) / 1e9,
            graph_pool_gb=_pool_bytes(torch, a._graph_pool) / 1e9)
        check(per[rid]["clone_param_bytes"] == 0,
              f"replicas: {rid}'s adapter copied "
              f"{per[rid]['clone_param_bytes']} bytes of the LM's weights")
    gen = functools.partial(srv.generate, "lm")
    gen(served["warm"], max_new_tokens=4, timeout=600)
    t0 = time.perf_counter()
    out = [o for w in served["waves"] for o in _run_wave(gen, w)[0]]
    wall = time.perf_counter() - t0
    same = [np.array_equal(a[1], b[1]) for a, b in zip(out,
                                                       served["results"])]
    check(len(out) == len(served["results"]) and all(same),
          f"replicas: generate with {REPLICAS} replicas differs from the "
          f"serve phase's tokens on {same.count(False)} requests")
    requests = {rid: v["requests"]
                for rid, v in rset.stats()["replicas"].items()}
    check(all(requests.values()), f"replicas: a decode replica served "
                                  f"nothing: {requests}")
    # the failover: route the next request to r0 (the router takes the
    # least recently routed of two idle replicas)
    if rset.replica("r0").last_routed > rset.replica("r1").last_routed:
        gen(served["warm"], max_new_tokens=4, timeout=600)
    prompt, want = served["results"][0][:2]
    before = rset.stats()["failovers"]
    with faults.plan(REPLICA_DECODE_FAIL):
        toks = gen(prompt, max_new_tokens=32, timeout=600)
    dstats = srv.decode_stats("lm")
    check(np.array_equal(toks, want)
          and rset.stats()["failovers"] == before + 1
          and dstats["r0"]["quarantined"] == 1,
          f"replicas: the decode failover gave {toks.tolist()} (want "
          f"{want.tolist()}), failovers {rset.stats()['failovers']}, "
          f"quarantined {dstats['r0']['quarantined']}")
    rset.check_leaks()
    gen_tokens = sum(len(o[1]) for o in out)
    return srv, rset, dict(
        bind_s=bind_s, per_replica=per, requests=requests, wall_s=wall,
        tokens_per_s=gen_tokens / wall, tokens_equal_to_serve=True,
        prefix_hits={r: s["prefix_hits"] for r, s in dstats.items()},
        failover=dict(spec=REPLICA_DECODE_FAIL, tokens_equal=True,
                      quarantined=dstats["r0"]["quarantined"]))


def phase_replicas(torch, dev, lm, served):
    """Multi-replica serving on the one card.  Predict: Predict's
    classifier (BERT-large fp32, seed 0) registered once and served by a
    ``replicas=1`` server and a ``replicas=2`` server (each replica its
    own five bucket graphs over the one snapshot, captured by prewarm);
    Predict's traffic through both in turns (1, 2, 2, 1), every response
    within ``PREDICT_TOL`` of the eager forward, both replicas serving,
    no build after prewarm.  A batch failed over between replicas against
    the ``replicas=1`` twin's program on the same inputs.  Under traffic:
    r0's dispatch failing twice (failovers); r0's heartbeat stalled
    (UNHEALTHY within the window, r1 serving alone), then cleared (r0
    captures its graphs again while r1 replays, and serves again); and
    ``restart("r1")``.  A replica on another device than the weights'
    must be refused.  Decode: ``_replica_decode``.  The B1/B4/B5 counters
    are zeroed just before the servers are built and read after the
    decode failover: they count the captures' eager warm-ups
    (``replicas_trace`` counts the replayed kernels).  Returns what
    ``phase_replicas_trace`` needs (the servers stay up)."""
    from mxnet_tpu_torch import faults
    from mxnet_tpu_torch.base import MXNetError
    from mxnet_tpu_torch.ops import flash_attention as fa
    from mxnet_tpu_torch.ops import paged_attention as pa
    from mxnet_tpu_torch.serving import (ModelRepository, ModelServer,
                                         ReplicaSet, ServingConfig,
                                         bucket_set, pad_batch)
    from mxnet_tpu_torch.serving.replica import HEALTHY, UNHEALTHY
    t_phase = time.perf_counter()
    clients = _predict_traffic(BERT_LARGE["vocab_size"])
    n_req = sum(len(c) for c in clients)
    clf = _bert_classifier(torch, dev, 0)
    want = _eager_logits(torch, dev, clf, clients)
    L = PREDICT_L
    example = (np.zeros((1, L), np.int32), np.zeros((1, L), np.int32),
               np.full((1,), L, np.int32))
    base = dict(max_batch_size=PREDICT_MAX_BATCH,
                num_workers=PREDICT_WORKERS, max_latency_us=2000)
    counters = (fa.flash_attention_fwd, pa.ragged_paged_attention,
                pa.ragged_paged_verify)
    for k in counters:
        k.launches = 0
    repo = ModelRepository()
    entry = repo.add_block("bert", clf, *example)
    del clf
    _free(torch)
    one = ModelServer(repo, ServingConfig(**base))
    two = ModelServer(repo, ServingConfig(replicas=REPLICAS, **base))
    one.prewarm("bert")
    t0 = time.perf_counter()
    two.prewarm("bert")
    prewarm_s = time.perf_counter() - t0
    rset = two.replica_set("bert")
    buckets = len(bucket_set(PREDICT_MAX_BATCH))
    captures = _replica_captures(torch, rset, entry)
    progs = [p for rid in rset.replicas()
             for p in rset.replica(rid).batcher.program_list(entry)]
    check(set(rset.replicas().values()) == {HEALTHY}
          and all(c["programs"] == buckets for c in captures.values())
          and len({id(p) for p in progs}) == REPLICAS * buckets
          and all(p.module is progs[0].module for p in progs),
          f"replicas: prewarm left {rset.replicas()}, {captures}")
    b1_prewarm = fa.flash_attention_fwd.launches
    check(b1_prewarm == 24 * buckets * (1 + REPLICAS),
          f"replicas: {b1_prewarm} B1 launches for "
          f"{buckets * (1 + REPLICAS)} captures (24 each)")
    # placement: a replica on another card than the weights' is refused
    try:
        ReplicaSet(entry, ServingConfig(replicas=REPLICAS, **base),
                   devices=[(dev,), (torch.device("cuda", 1),)],
                   autostart=False)
        refused = None
    except MXNetError as e:
        refused = str(e)
    check(refused and "item 5" in refused,
          "replicas: a replica on another device than the weights' was "
          "not refused")

    # replicas=1 and replicas=2 in turns
    misses = {rid: rset.replica(rid).batcher.bucket_misses
              for rid in rset.replicas()}
    misses_one = one.stats()["bucket_misses"]
    turns = {1: [], REPLICAS: []}
    scale = 0.0
    for n in (1, REPLICAS, REPLICAS, 1):
        got, wall = _run_clients(one if n == 1 else two, clients)
        err, scale = _predict_err(got, want)
        tol = PREDICT_TOL * scale
        check(err <= tol, f"replicas: replicas={n} responses off by {err} "
                          f"(tolerance {tol})")
        lat = sorted(tb - ta for c in got for _y, ta, tb in c)
        turns[n].append(dict(wall_s=wall, requests_per_s=n_req / wall,
                             p50_ms=float(np.percentile(lat, 50)) * 1e3,
                             p99_ms=float(np.percentile(lat, 99)) * 1e3,
                             max_abs_err=err))
    tol = PREDICT_TOL * scale
    served_by = {rid: v["requests"]
                 for rid, v in rset.stats()["replicas"].items()}
    check(all(served_by.values()), f"replicas: a replica served nothing: "
                                   f"{served_by}")
    check(all(rset.replica(rid).batcher.bucket_misses == m
              for rid, m in misses.items())
          and one.stats()["bucket_misses"] == misses_one,
          "replicas: a bucket was built on the request path after prewarm")

    # chaos under traffic 1: r0's dispatch fails twice
    fo0 = rset.stats()["failovers"]
    with faults.plan("replica.r0.execute=fail,times=2"):
        got, _ = _run_clients(two, clients)
    err, _ = _predict_err(got, want)
    check(err <= tol and rset.stats()["failovers"] > fo0
          and rset.replicas()["r0"] == HEALTHY,
          f"replicas: execute failures gave err {err}, failovers "
          f"{rset.stats()['failovers'] - fo0}, {rset.replicas()}")
    execute_chaos = dict(failovers=rset.stats()["failovers"] - fo0,
                         max_abs_err=err)

    # a failed-over batch against the replicas=1 twin, same inputs (after
    # r0's last outcomes were successes: two more failures stay under
    # its consecutive-failure trip of 3)
    twin = {str(rows): _twin_failover(rset, one, entry,
                                      _fill_bucket(clients, rows), scale)
            for rows in (PREDICT_MAX_BATCH, 4)}

    # chaos under traffic 2: r0's heartbeat stalls, then clears
    cfg2 = two.config
    stop = threading.Event()
    runner, rec = _replica_traffic(two, clients, want, tol, stop,
                                   "replicas stall")
    r0 = rset.replica("r0")
    prewarms0 = r0.prewarms
    rejoins0 = rset.stats()["rejoins"]
    faults.install(f"replica.r0.heartbeat=stall,ms={REPLICA_STALL_MS},"
                   f"times=1")
    t_stall = time.perf_counter()
    try:
        detect_s = _wait_for(lambda: rset.replicas()["r0"] == UNHEALTHY,
                             30, "replicas: r0 never went UNHEALTHY")
        r0_dark, r1_dark = r0.requests, rset.replica("r1").requests
        faults.clear()
        _wait_for(lambda: time.perf_counter() - t_stall
                  >= 0.8 * REPLICA_STALL_MS / 1e3, 30, "replicas stall")
        dark = dict(r0=r0.requests - r0_dark,
                    r1=rset.replica("r1").requests - r1_dark)
        check(rset.replicas()["r0"] != HEALTHY and dark["r0"] == 0
              and dark["r1"] > 0,
              f"replicas: in r0's dark window r0 took {dark['r0']} and r1 "
              f"{dark['r1']} dispatches, state {rset.replicas()}")
        rejoin_s = _wait_for(lambda: rset.replicas()["r0"] == HEALTHY,
                             300, "replicas: r0 never rejoined")
        r0_back = r0.requests
        _wait_for(lambda: r0.requests > r0_back, 300,
                  "replicas: r0 took no traffic after it rejoined")
    finally:
        faults.clear()
        stop.set()
    stall_traffic = _join_traffic(runner, rec, "replicas stall")
    window_s = (cfg2.replica_heartbeat_window_ms
                + 2 * cfg2.replica_heartbeat_ms) / 1e3
    check(detect_s <= window_s + 0.5,
          f"replicas: r0 marked UNHEALTHY {detect_s:.3f} s into its "
          f"stall (window {window_s} s)")
    check(r0.prewarms == prewarms0 + 1
          and rset.stats()["rejoins"] == rejoins0 + 1,
          f"replicas: r0 rejoined without one prewarm: {rset.stats()}")
    rejoin_capture = _replica_captures(torch, rset, entry)["r0"]

    # chaos under traffic 3: restart r1
    stop = threading.Event()
    runner, rec = _replica_traffic(two, clients, want, tol, stop,
                                   "replicas restart")
    _wait_for(lambda: rec["passes"] >= 1 or rec["error"], 600,
              "replicas restart")
    old_r1 = rset.replica("r1")
    t0 = time.perf_counter()
    try:
        rset.restart("r1", timeout=120)
    finally:
        stop.set()
    restart_s = time.perf_counter() - t0
    restart_traffic = _join_traffic(runner, rec, "replicas restart")
    new_r1 = rset.replica("r1")
    check(new_r1 is not old_r1 and rset.replicas()["r1"] == HEALTHY
          and new_r1.prewarms == 1,
          f"replicas: restart left r1 {rset.replicas()['r1']}: "
          f"{new_r1.unhealthy_reason}")
    restart_capture = _replica_captures(torch, rset, entry)["r1"]
    b1_predict = fa.flash_attention_fwd.launches
    check(b1_predict == 24 * buckets * (1 + REPLICAS + 2),
          f"replicas: {b1_predict} B1 launches, want 24 for each of "
          f"{buckets * (1 + REPLICAS + 2)} captures")

    # decode
    dsrv, drs, decode = _replica_decode(torch, dev, lm, served)
    launches = {k.__name__: k.launches for k in counters}
    check(all(launches.values()),
          f"replicas: a kernel of the path never launched: {launches}")
    check(launches["ragged_paged_attention"] == REPLICAS * lm.num_layers,
          f"replicas: {launches['ragged_paged_attention']} B4 launches, "
          f"want {lm.num_layers} in each decode replica's capture")
    padded16, _ = pad_batch(_fill_bucket(clients, PREDICT_MAX_BATCH),
                            PREDICT_MAX_BATCH)
    # the trace at the end replays each replica's bucket-16 graph; every
    # server stops now, so no heartbeat thread or replica bring-up runs
    # beside the later phases
    progs16 = {rid: rset.replica(rid).batcher.program_list(entry)[-1]
               for rid in rset.replicas()}
    stats = rset.stats()
    for srv in (two, one, dsrv):
        check(srv.stop(timeout=120), "replicas: a server did not stop")
    check(set(rset.replicas().values()) == {"stopped"}
          and set(drs.replicas().values()) == {"stopped"},
          f"replicas: after stop {rset.replicas()}, {drs.replicas()}")
    # a stopped engine has released every page, prefix-cache holds too
    held = {rid: drs.replica(rid).engine.allocator.used_pages
            for rid in drs.replicas()}
    check(not any(held.values()), f"replicas: pages held after the "
                                  f"decode server stopped: {held}")
    drs.check_leaks()
    emit("replicas", replicas=REPLICAS, requests=n_req,
         turns={f"replicas={n}": v for n, v in turns.items()},
         served_by=served_by, prewarm_s=prewarm_s,
         captures=captures, rejoin_capture=rejoin_capture,
         restart_capture=restart_capture, restart_s=restart_s,
         twin_failover=twin, execute_chaos=execute_chaos,
         stall=dict(stall_ms=REPLICA_STALL_MS, detect_s=detect_s,
                    window_s=window_s, dark_window_dispatches=dark,
                    rejoin_s=rejoin_s, traffic=stall_traffic),
         restart_traffic=restart_traffic, refused_placement=refused,
         decode=decode, stats=stats, kernel_launches=launches,
         max_abs_logit=scale, tolerance=tol,
         seconds=time.perf_counter() - t_phase)
    return dict(progs16=progs16, padded16=padded16, launches=launches)


def phase_replicas_trace(torch, ctx):
    """Each predict replica's bucket-16 graph (kept from the ``replicas``
    phase, whose servers have stopped) replayed ``ARTIFACT_TRACE_REPLAYS``
    times under ``torch.profiler``: 24 B1 records a replay, no wrapper
    count.  Returns the records and replays."""
    out = {"b1_records": 0, "bucket16": {}}
    for rid, prog in ctx["progs16"].items():
        check(prog.rows == PREDICT_MAX_BATCH, "replicas_trace: bucket")
        _y, records, kernels, fam = _traced_replays(
            torch, prog, ctx["padded16"], f"replicas_trace {rid}")
        out["b1_records"] += records
        out["bucket16"][rid] = dict(kernels=kernels,
                                    device_ms_by_family=fam)
    out["b1_replays"] = ARTIFACT_TRACE_REPLAYS * len(ctx["progs16"])
    emit("replicas_trace", **out)
    return out


# ------------------------------------------------------------- traffic
# the traffic phase (docs/serving.md §11): a seeded multi-tenant burst
# trace recorded to JSONL, loaded back and replayed by closed-loop
# clients through one ModelServer holding Predict's classifier ("bert",
# its bucket graphs) and the serving LM ("gpt2", prefix cache on), each
# behind a ReplicaSet with an SLO autoscaler, tenants behind the
# reference bench's tiers (benchmark/bench_traffic.py).  A trace row's
# ``op`` picks its model: predict rows go to "bert", generate rows to
# "gpt2".  Prompts are long enough (median 32 tokens, clusters sharing
# their first 32) that a cluster's later prompts hit the prefix cache
# and run B5 over its pages; predict rows carry 1-12 rows, so the burst
# asks ~490 rows/s of a card whose two bert replicas serve ~350-380
# (``replicas``).
TRAFFIC_TIERS = "gold=100,silver=10/8/12,free=1/2/4"
TRAFFIC_TRACE = dict(
    seed=0, duration_s=8.0, base_rate=14.0, process="lognormal",
    tenants=6, tiers=("gold", "silver", "free"), models=("bert", "gpt2"),
    generate_fraction=0.35, burst_at=0.45, burst_x=10.0,
    burst_duration_s=2.0, prompt_max=64, output_max=16,
    prompt_len_median=32.0, prefix_len=32, rows_max=12)
TRAFFIC_REPLICAS = 2                     # each model's seed replicas
TRAFFIC_RUNS = (("frozen", 2), ("scaled", 4))   # the autoscalers' ceiling
TRAFFIC_AUTOSCALE = dict(interval_s=0.1, breach_ticks=2, idle_ticks=10,
                         cooldown_up_s=0.8, cooldown_down_s=2.0,
                         drain_timeout_s=30.0)
TRAFFIC_CLIENTS = 32
# dispatch workers: one a replica at the ceiling, so that a burst queues
# in the server (where the autoscaler's queue sensor reads it) and not
# behind a replica's program lock
TRAFFIC_WORKERS = 4
# bert's queue-depth target beside its latency target: a full bucket
# waiting in the server's queue
TRAFFIC_QUEUE_HIGH = PREDICT_MAX_BATCH
TRAFFIC_TIMEOUT_S = 10.0                 # each request's deadline
# the quiet tail after the trace: the autoscalers run on until both sets
# are back at their seed replicas or this bound passes
TRAFFIC_QUIET_S = 15.0
# r0's heartbeat stalls as the burst lands, in each set (both runs): the
# site is named by replica id, so the first two r0 beats after the plan
# is installed take it — one a model, as a stalled r0 sleeps through
# its next beat
TRAFFIC_STALL = "replica.r0.heartbeat=stall,ms=1500,times=2"
TRAFFIC_EAGER_PREDICT, TRAFFIC_EAGER_GENERATE = 16, 4
TRAFFIC_TRACE_S = 2.0                    # traffic_trace: the trace's head
# traffic_trace's heartbeat window: starting the profiler once stalled
# every thread ~0.64 s, so all replicas went stale at once and rejoined,
# recapturing inside the trace; that phase counts kernels, not health
TRAFFIC_TRACE_HEARTBEAT_WINDOW_MS = 60_000


def _traffic_trace(tmp):
    """The phase's trace, generated, saved to JSONL and loaded back (the
    replay runs from the file): the loaded trace must save back to the
    same bytes."""
    from mxnet_tpu_torch.serving import Trace, TraceConfig, generate_trace
    path = os.path.join(tmp, "traffic.jsonl")
    generate_trace(TraceConfig(**TRAFFIC_TRACE)).save(path)
    trace = Trace.load(path)
    with open(path) as fh:
        check(fh.read() == trace.to_jsonl(),
              "traffic: the loaded trace does not save back byte for byte")
    return trace, path


def _traffic_inputs(req, vocab):
    """A predict row's classifier inputs, from the row's own seed: rows
    of L = 128 tokens, valid lengths 16-128, the second segment from half
    the valid length on (Predict's traffic shape)."""
    rs = np.random.RandomState(req.seed)
    L = PREDICT_L
    valid = rs.randint(16, L + 1, req.rows).astype(np.int32)
    tokens = rs.randint(0, vocab, (req.rows, L)).astype(np.int32)
    types = (np.arange(L)[None] >= valid[:, None] // 2).astype(np.int32)
    return tokens, types, valid


def _traffic_prompt(req, vocab):
    from mxnet_tpu_torch.serving import traffic
    return np.asarray(traffic.prompt_tokens(
        req, vocab=vocab, prefix_len=TRAFFIC_TRACE["prefix_len"]), np.int32)


def _traffic_server(torch, dev, clf, lm, replicas, **config):
    """The phase's server: ``clf`` as "bert" (Predict's buckets) and the
    LM as "gpt2" (a fresh adapter over the one LM per replica, from
    ``model_factory``), ``replicas`` each, both prewarmed (every
    replica's graphs captured); ``config`` adds ``ServingConfig``
    fields."""
    from mxnet_tpu_torch.serving import (ModelRepository, ModelServer,
                                         PagedLMAdapter, ServingConfig)
    L = PREDICT_L
    example = (np.zeros((1, L), np.int32), np.zeros((1, L), np.int32),
               np.full((1,), L, np.int32))
    repo = ModelRepository()
    repo.add_block("bert", clf, *example)
    repo.add_decoder("gpt2", lm,
                     model_factory=lambda: PagedLMAdapter(lm, device=dev))
    cfg = ServingConfig(
        replicas=replicas, tenant_tiers=TRAFFIC_TIERS,
        max_batch_size=PREDICT_MAX_BATCH, num_workers=TRAFFIC_WORKERS,
        max_latency_us=2000,
        decode_page_size=PAGE_SIZE, decode_pool_pages=POOL_PAGES,
        decode_max_batch=MAX_BATCH, prefix_cache=True,
        decode_max_new_tokens=TRAFFIC_TRACE["output_max"], **config)
    srv = ModelServer(repo, cfg)
    t0 = time.perf_counter()
    srv.prewarm("bert")
    srv.prewarm("gpt2")
    return srv, repo, time.perf_counter() - t0


def _traffic_call(srv, trace, vocab_bert, vocab_lm, out):
    """``replay_trace``'s round trip: a predict row through
    ``srv.predict("bert")``, a generate row through
    ``srv.generate("gpt2")`` (TTFT from its first streamed token), the
    tenant as "name:tier".  ``out`` gets each ok response by trace index
    and every shed attempt's tier and kind (quota / pressure / other)."""
    from mxnet_tpu_torch.serving import ServerOverloadedError
    index = {id(r): i for i, r in enumerate(trace.requests)}
    lock = threading.Lock()

    def call(req):
        tenant = f"{req.tenant}:{req.tier}"
        try:
            if req.op == "predict":
                y = srv.predict("bert", *_traffic_inputs(req, vocab_bert),
                                tenant=tenant, timeout=TRAFFIC_TIMEOUT_S)
                with lock:
                    out["predict"][index[id(req)]] = y
                return None
            t0 = time.monotonic()
            first = []
            toks = srv.generate(
                "gpt2", _traffic_prompt(req, vocab_lm),
                max_new_tokens=req.max_new_tokens, tenant=tenant,
                timeout=TRAFFIC_TIMEOUT_S,
                on_token=lambda _t: first or first.append(time.monotonic()))
            with lock:
                out["generate"][index[id(req)]] = np.asarray(toks)
            return {"ttft_s": first[0] - t0 if first else None}
        except ServerOverloadedError as e:
            msg = str(e)
            kind = "quota" if "quota" in msg else \
                "pressure" if "priority shedding" in msg else "other"
            with lock:
                out["sheds"].append((req.tier, kind))
            raise
    return call


def _watch_ups(torch, rset, log):
    """Record every ``add_replica`` the autoscaler makes on ``rset``:
    the new replica's state, its graphs and capture seconds, the call's
    seconds (the measured prewarm) and the reserved memory after it."""
    add = rset.add_replica

    def add_replica():
        t0 = time.perf_counter()
        rid = add()
        rep = rset.replica(rid)
        log.append(dict(
            model=rset.name, rid=rid, state=rset.replicas()[rid],
            seconds=time.perf_counter() - t0,
            capture_s=rep.capture_seconds(),
            graphs=len(rep.batcher.program_list(rset.entry))
            if rep.batcher is not None else rep.engine.model.compiled,
            reserved_gb=torch.cuda.memory_reserved() / 1e9))
        return rid

    rset.add_replica = add_replica


def _watch_decisions(asc, t0, log):
    """Keep every decision of ``asc`` but its holds and blocks (which
    the autoscaler's own ring of 32 lets evict the rest), its time
    relative to ``t0[0]``, and count the blocks."""
    tick = asc.tick
    log["blocked"] = 0

    def watched(now=None):
        d = tick(now)
        if d is not None and d["action"] == "blocked":
            log["blocked"] += 1
        elif d is not None and d["action"] != "hold":
            log.setdefault("decisions", []).append(dict(
                {k: d[k] for k in ("action", "reason", "replicas",
                                   "target", "queue_depth", "ttft_p99_s",
                                   "latency_p99_s")},
                t=d["t"] - t0[0]))
        return d

    asc.tick = watched


def _reserved_settled(torch):
    gc.collect()
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    return torch.cuda.memory_reserved()


def _memory_by_pool(torch):
    """Reserved and allocated bytes on the card by pool: the caching
    allocator's default pool apart from the CUDA-graph pools."""
    out = {"default_reserved": 0, "default_allocated": 0,
           "graph_reserved": 0, "graph_allocated": 0, "graph_pools": 0}
    pools = set()
    for seg in torch.cuda.memory_snapshot():
        pool = tuple(seg.get("segment_pool_id", ()) or ())
        kind = "default" if not any(pool) else "graph"
        if kind == "graph":
            pools.add(pool)
        out[f"{kind}_reserved"] += seg["total_size"]
        out[f"{kind}_allocated"] += seg["allocated_size"]
    out["graph_pools"] = len(pools)
    return out


def _watch_downs(torch, rset, log):
    """Record every ``remove_replica`` on ``rset`` with the memory by
    pool after it returns."""
    remove = rset.remove_replica

    def remove_replica(rid, timeout=None):
        t0 = time.perf_counter()
        out = remove(rid, timeout=timeout)
        log.append(dict(model=rset.name, rid=rid,
                        seconds=time.perf_counter() - t0,
                        memory=_memory_by_pool(torch)))
        return out

    rset.remove_replica = remove_replica


def _replica_bytes(torch, srv):
    """Device bytes one replica of each model holds of its own: a bert
    replica's bucket-graph pools, a gpt2 replica's graph pool and KV
    pool."""
    bert, gpt2 = srv.replica_set("bert"), srv.replica_set("gpt2")
    b0 = bert.replica(next(iter(bert.replicas())))
    a = gpt2.replica(next(iter(gpt2.replicas()))).engine.model
    return dict(
        bert=sum(_pool_reserved(torch, p.pool)
                 for p in b0.batcher.program_list(bert.entry)),
        gpt2=_pool_reserved(torch, a._graph_pool)
        + a.pool.k_pages.numel() * a.pool.k_pages.element_size()
        + a.pool.v_pages.numel() * a.pool.v_pages.element_size())


def _traffic_run(torch, dev, clf, lm, trace, label, ceiling, slo):
    """One replay of ``trace`` on a fresh server (two replicas a model)
    with an ``Autoscaler`` per model whose ceiling is ``ceiling``
    replicas, the stall chaos as the burst lands, then the quiet tail.
    Returns the run's record, its responses, and the larger of one bert
    and one gpt2 replica's device bytes (the memory check's bound)."""
    from mxnet_tpu_torch import faults, runtime_metrics as rm
    from mxnet_tpu_torch.serving import (Autoscaler, AutoscalerConfig,
                                         SLOTargets, replay_trace,
                                         summarize)
    from mxnet_tpu_torch.serving.replica import UNHEALTHY
    t_run = time.perf_counter()
    rm.reset()
    rm.enable()
    srv, _repo, prewarm_s = _traffic_server(torch, dev, clf, lm,
                                            TRAFFIC_REPLICAS)
    sets = {m: srv.replica_set(m) for m in ("bert", "gpt2")}
    per_replica = _replica_bytes(torch, srv)
    ups, downs = [], []
    for rset in sets.values():
        _watch_ups(torch, rset, ups)
        _watch_downs(torch, rset, downs)
    targets = {"bert": SLOTargets(latency_p99_ms=slo["latency_p99_ms"],
                                  queue_high=TRAFFIC_QUEUE_HIGH),
               "gpt2": SLOTargets(ttft_p99_ms=slo["ttft_p99_ms"])}
    scalers = {m: Autoscaler(
        rset, targets[m], AutoscalerConfig(
            min_replicas=TRAFFIC_REPLICAS, max_replicas=ceiling,
            **TRAFFIC_AUTOSCALE), server_name=srv.name)
        for m, rset in sets.items()}
    t0 = [time.monotonic()]
    ledger = {m: {} for m in scalers}
    for m, a in scalers.items():
        _watch_decisions(a, t0, ledger[m])
    reserved0 = _reserved_settled(torch)
    memory0 = _memory_by_pool(torch)
    out = {"predict": {}, "generate": {}, "sheds": []}
    call = _traffic_call(srv, trace, BERT_LARGE["vocab_size"],
                         lm.vocab_size, out)
    stall = {}
    go = threading.Event()

    def chaos():
        go.wait(60)
        time.sleep(TRAFFIC_TRACE["burst_at"] * TRAFFIC_TRACE["duration_s"])
        faults.install(TRAFFIC_STALL)
        t0 = time.perf_counter()
        try:
            while time.perf_counter() - t0 < 5.0 and len(stall) < 2:
                for m, rset in sets.items():
                    dark = [r for r, s in rset.replicas().items()
                            if s == UNHEALTHY]
                    if dark and m not in stall:
                        stall[m] = dict(rid=dark[0],
                                        detect_s=time.perf_counter() - t0)
                time.sleep(0.005)
        finally:
            faults.clear()

    killer = threading.Thread(target=chaos, daemon=True)
    killer.start()
    try:
        t0[0] = time.monotonic()
        for a in scalers.values():
            a.start()
        go.set()
        records, wall_s = replay_trace(
            trace, call, clients=TRAFFIC_CLIENTS, speed=1.0,
            timeout_s=TRAFFIC_TIMEOUT_S)
        t_quiet = time.perf_counter()
        _wait_for(lambda: all(
            len(rs.replicas()) <= TRAFFIC_REPLICAS
            for rs in sets.values())
            or time.perf_counter() - t_quiet > TRAFFIC_QUIET_S,
            TRAFFIC_QUIET_S + 5, f"traffic {label}: quiet tail")
        quiet_s = time.perf_counter() - t_quiet
    finally:
        for a in scalers.values():
            a.stop()
        killer.join(10)
    replicas_end = {m: rs.replicas() for m, rs in sets.items()}
    stats = {m: a.stats() for m, a in scalers.items()}
    srv_stats = srv.stats()
    prefix_hits = sum(rm.SERVING_PREFIX_HITS.value(model=m)
                      for m in rm.SERVING_PREFIX_HITS.label_values("model"))
    # after the quiet tail's last scale-down, the server still up
    reserved1 = _reserved_settled(torch)
    memory1 = _memory_by_pool(torch)
    check(srv.stop(timeout=120), f"traffic {label}: the server did not stop")
    rm.disable()
    rm.reset()

    by_op = {op: [r for r in records if r["op"] == op]
             for op in ("predict", "generate")}
    summary = {
        "all": summarize(records, wall_s=wall_s,
                         latency_slo_s=None, ttft_slo_s=None),
        "bert": summarize(by_op["predict"], wall_s=wall_s,
                          latency_slo_s=slo["latency_p99_ms"] / 1e3),
        "gpt2": summarize(by_op["generate"], wall_s=wall_s,
                          ttft_slo_s=slo["ttft_p99_ms"] / 1e3)}
    slo_ok = summary["bert"]["slo_ok"] + summary["gpt2"]["slo_ok"]
    shed_rate = {t: v["shed"] / v["requests"]
                 for t, v in summary["all"]["by_tier"].items()}
    kinds = {}
    for tier, kind in out["sheds"]:
        kinds.setdefault(tier, {}).setdefault(kind, 0)
        kinds[tier][kind] += 1
    run = dict(
        label=label, ceiling=ceiling, requests=len(records),
        wall_s=wall_s, prewarm_s=prewarm_s, quiet_s=quiet_s,
        attainment=slo_ok / len(records),
        goodput_rps=slo_ok / wall_s,
        ttft_p50_ms=summary["gpt2"]["ttft_p50_s"] * 1e3,
        ttft_p99_ms=summary["gpt2"]["ttft_p99_s"] * 1e3,
        latency_p99_ms={m: summary[m]["latency_p99_s"] * 1e3
                        for m in ("bert", "gpt2")},
        statuses={s: summary["all"][s] for s in
                  ("ok", "shed", "deadline", "error")},
        shed_rate=shed_rate, shed_attempts=kinds,
        by_model={m: {k: summary[m][k] for k in
                      ("requests", "ok", "shed", "deadline", "slo_ok",
                       "attainment", "goodput_rps")}
                  for m in ("bert", "gpt2")},
        autoscale={m: {k: s[k] for k in ("ticks", "up", "down", "hold",
                                         "blocked", "error",
                                         "prewarm_estimate_s")}
                   for m, s in stats.items()},
        ledger=ledger, ups=ups, downs=downs, stall=stall,
        replicas_end=replicas_end,
        reserved_before_gb=reserved0 / 1e9,
        reserved_after_gb=reserved1 / 1e9,
        memory_before=memory0, memory_after=memory1,
        replica_bytes_gb={m: v / 1e9 for m, v in per_replica.items()},
        admission=srv_stats.get("admission", {}).get("by_tenant"),
        prefix_hits=prefix_hits,
        seconds=time.perf_counter() - t_run)
    # the run's record first: a failed check below still leaves it
    emit("traffic_run", **run)
    statuses = {r["status"] for r in records}
    check(statuses <= {"ok", "shed", "deadline"},
          f"traffic {label}: statuses {statuses}; errors "
          f"{sorted({r['error'] for r in records if r['status'] == 'error'})}")
    check(shed_rate.get("free", 0.0) >= shed_rate.get("gold", 0.0),
          f"traffic {label}: free's shed rate {shed_rate.get('free')} "
          f"below gold's {shed_rate.get('gold')}")
    check(not kinds.get("gold", {}).get("pressure"),
          f"traffic {label}: gold was pressure-shed: {kinds}")
    return run, out, max(per_replica.values())


def phase_traffic(torch, dev, lm, served, predict):
    """Tenant tiers, SLO autoscaling and trace replay on the card: the
    seeded burst trace (``TRAFFIC_TRACE``: 8 s, 14 requests/s with a 10x
    burst of 2 s at 0.45 of the trace, 6 tenants over gold / silver /
    free) recorded to JSONL and replayed from the file twice, each time
    on a fresh ``ModelServer(replicas=2, tenant_tiers=...)`` holding
    BERT-large fp32 (B1 in every bucket graph) and GPT-2 small (B4 / B5
    in its decode and verify graphs), with one ``Autoscaler`` a model
    (bert: this run's ``predict`` p99 latency and a queue of one full
    bucket; gpt2: this run's ``serve`` TTFT p99): ``frozen`` (ceiling 2
    replicas) and ``scaled`` (ceiling 4).  Both runs stall r0's
    heartbeat in each set as the burst lands.  Hard checks: the replay returns (no request hung), every
    non-ok status is shed or deadline; the scaled run adds a bert
    replica that is HEALTHY with its five graphs when ``add_replica``
    returns; its quiet tail removes at least one replica, after which
    the reserved memory is within one replica's device bytes (the larger
    of a bert replica's graph pools and a gpt2 replica's graph and KV
    pools) of its value before the run; free's shed rate is at least gold's, and
    gold is never pressure-shed; the first 16 ok bert responses of each
    run within ``PREDICT_TOL`` of the eager classifier, and four ok
    generations with no shared prefix equal an eager (``graphs=False``)
    engine's greedy tokens.  The B1/B4/B5 counters are zeroed before the
    first server is built and read after the second run (the captures'
    eager warm-ups, scale-ups' included); ``traffic_trace`` counts the
    replays.  Returns what ``traffic_trace`` needs."""
    from mxnet_tpu_torch.ops import flash_attention as fa
    from mxnet_tpu_torch.ops import paged_attention as pa
    from mxnet_tpu_torch.serving import (DecodeEngine, PagedLMAdapter,
                                         ServingConfig, bucket_set)
    t_phase = time.perf_counter()
    tmp = tempfile.mkdtemp(prefix="traffic-")
    try:
        trace, path = _traffic_trace(tmp)
        trace_bytes = os.path.getsize(path)
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    ttfts = [r[2] for r in served["results"]]
    slo = dict(latency_p99_ms=predict["latency_p99_ms"],
               ttft_p99_ms=float(np.percentile(ttfts, 99)) * 1e3)
    clf = _bert_classifier(torch, dev, 0)
    counters = (fa.flash_attention_fwd, pa.ragged_paged_attention,
                pa.ragged_paged_verify)
    for k in counters:
        k.launches = 0
    runs, outs, tol_bytes = {}, {}, {}
    for label, ceiling in TRAFFIC_RUNS:
        runs[label], outs[label], tol_bytes[label] = _traffic_run(
            torch, dev, clf, lm, trace, label, ceiling, slo)
    launches = {k.__name__: k.launches for k in counters}
    check(all(launches.values()),
          f"traffic: a kernel of the path never launched: {launches}")

    scaled = runs["scaled"]
    buckets = len(bucket_set(PREDICT_MAX_BATCH))
    bert_ups = [u for u in scaled["ups"] if u["model"] == "bert"]
    check(scaled["autoscale"]["bert"]["up"] >= 1 and bert_ups,
          f"traffic: the scaled run added no bert replica: "
          f"{scaled['ledger']['bert']}")
    check(all(u["state"] == "healthy" and u["graphs"] == buckets
              for u in bert_ups),
          f"traffic: an added bert replica was not routable with its "
          f"{buckets} graphs: {bert_ups}")
    downs = sum(s["down"] for s in scaled["autoscale"].values())
    check(downs >= 1, f"traffic: no replica was removed in the quiet "
                      f"tail: {scaled['replicas_end']}")
    grown = scaled["reserved_after_gb"] - scaled["reserved_before_gb"]
    check(grown * 1e9 <= tol_bytes["scaled"],
          f"traffic: reserved memory grew {grown:.3f} GB over the run, "
          f"more than one replica's {tol_bytes['scaled'] / 1e9:.3f} GB")
    for run in runs.values():
        check(all(len(v) <= run["ceiling"] for v in
                  run["replicas_end"].values()),
              f"traffic {run['label']}: above its ceiling")

    # the served outputs against the eager module and an eager engine
    # (after the counters were read: these launch B1 / B4 / B5 eagerly)
    reqs = trace.requests
    parity = {}
    eager = DecodeEngine(
        PagedLMAdapter(lm, device=dev, graphs=False),
        ServingConfig(decode_page_size=PAGE_SIZE,
                      decode_pool_pages=POOL_PAGES,
                      decode_max_batch=MAX_BATCH,
                      decode_max_new_tokens=TRAFFIC_TRACE["output_max"]),
        model_name="gpt2-traffic-eager", autostart=True)
    try:
        for label, out in outs.items():
            idx = sorted(out["predict"])[:TRAFFIC_EAGER_PREDICT]
            check(len(idx) == TRAFFIC_EAGER_PREDICT,
                  f"traffic {label}: {len(idx)} ok bert responses")
            err = scale = 0.0
            with torch.no_grad():
                for i in idx:
                    x = _traffic_inputs(reqs[i], BERT_LARGE["vocab_size"])
                    want = clf(*(torch.from_numpy(a).to(dev)
                                 for a in x)).cpu().numpy()
                    got = out["predict"][i]
                    check(got.shape == want.shape
                          and np.isfinite(got).all(),
                          f"traffic {label}: response {i} of shape "
                          f"{got.shape}")
                    err = max(err, float(np.abs(got - want).max()))
                    scale = max(scale, float(np.abs(want).max()))
            check(err <= PREDICT_TOL * scale,
                  f"traffic {label}: bert responses off the eager "
                  f"classifier by {err} (tolerance {PREDICT_TOL * scale})")
            gidx = [i for i in sorted(out["generate"])
                    if reqs[i].prefix_group is None][:TRAFFIC_EAGER_GENERATE]
            check(len(gidx) == TRAFFIC_EAGER_GENERATE,
                  f"traffic {label}: {len(gidx)} ok generations without "
                  f"a shared prefix")
            for i in gidx:
                want = eager.generate(
                    _traffic_prompt(reqs[i], lm.vocab_size),
                    max_new_tokens=reqs[i].max_new_tokens, timeout=600)
                check(np.array_equal(out["generate"][i], want),
                      f"traffic {label}: generation {i} gave "
                      f"{out['generate'][i].tolist()}, the eager engine "
                      f"{np.asarray(want).tolist()}")
            parity[label] = dict(predict=len(idx), max_abs_err=err,
                                 max_abs_logit=scale,
                                 generate_equal=len(gidx))
    finally:
        check(eager.stop(timeout=120), "traffic: eager engine did not stop")
    del clf
    _free(torch)
    frozen = runs["frozen"]
    emit("traffic", trace=dict(requests=len(reqs), jsonl_bytes=trace_bytes,
                               **{k: v for k, v in TRAFFIC_TRACE.items()
                                  if k != "tiers"}),
         tiers=TRAFFIC_TIERS, slo=slo, clients=TRAFFIC_CLIENTS,
         runs={k: {f: v[f] for f in (
             "attainment", "goodput_rps", "ttft_p50_ms", "ttft_p99_ms",
             "latency_p99_ms", "shed_rate", "autoscale", "ups")}
             for k, v in runs.items()},
         parity=parity, kernel_launches=launches,
         scaled_minus_frozen=dict(
             attainment=scaled["attainment"] - frozen["attainment"],
             goodput_rps=scaled["goodput_rps"] - frozen["goodput_rps"]),
         seconds=time.perf_counter() - t_phase)
    peak = max([TRAFFIC_REPLICAS] + [
        d["target"] for led in scaled["ledger"].values()
        for d in led.get("decisions", ()) if d["action"] == "up"])
    return dict(trace=trace, replicas=peak, launches=launches)


def phase_traffic_trace(torch, dev, lm, ctx):
    """The trace's first ``TRAFFIC_TRACE_S`` seconds replayed under
    ``torch.profiler`` (after a warm-up replay of each bert bucket
    graph in the trace) on a server with the replica count the scaled run
    reached (every replica's graphs captured before the trace, no
    autoscaler, heartbeat window ``TRAFFIC_TRACE_HEARTBEAT_WINDOW_MS``): every batch and decode step replays a
    graph, so the wrappers count nothing and the records equal exactly
    24 B1 a bucket replay, ``num_layers`` B4 a decode replay and
    ``num_layers`` B5 a verify replay.  Returns the records."""
    from mxnet_tpu_torch.ops import flash_attention as fa
    from mxnet_tpu_torch.ops import paged_attention as pa
    from mxnet_tpu_torch.serving import Trace, pad_batch, replay_trace
    trace = ctx["trace"]
    head = Trace(trace.header, [r for r in trace.requests
                                if r.t < TRAFFIC_TRACE_S])
    clf = _bert_classifier(torch, dev, 0)
    srv, _repo, _ = _traffic_server(
        torch, dev, clf, lm, ctx["replicas"],
        replica_heartbeat_window_ms=TRAFFIC_TRACE_HEARTBEAT_WINDOW_MS)
    del clf
    kernels = (fa.flash_attention_fwd, pa.ragged_paged_attention,
               pa.ragged_paged_verify)
    try:
        bert, gpt2 = srv.replica_set("bert"), srv.replica_set("gpt2")

        def replays():
            out = {}
            for rid in bert.replicas():
                for p in bert.replica(rid).batcher.program_list(bert.entry):
                    out[("bucket", rid, p.rows)] = p.replays
            for rid in gpt2.replicas():
                for k, p in gpt2.replica(rid).engine.model._programs.items():
                    out[(k[0], rid) + tuple(k[1:])] = p.replays
            return out

        out = {"predict": {}, "generate": {}, "sheds": []}
        call = _traffic_call(srv, head, BERT_LARGE["vocab_size"],
                             lm.vocab_size, out)
        counted = [k.launches for k in kernels]
        names = dict(KERNEL_NAMES, flash_attention_fwd=FLASH_NAMES[
            "flash_attention_fwd"])
        holder = {}
        one_row = (np.ones((1, PREDICT_L), np.int32),
                   np.zeros((1, PREDICT_L), np.int32),
                   np.full((1,), PREDICT_L, np.int32))

        def warm():
            # each bert replica's bucket graphs, so that the trace's
            # first counted launch is not its first launch
            for rid in bert.replicas():
                for p in bert.replica(rid).batcher.program_list(bert.entry):
                    p(*pad_batch([one_row], p.rows)[0])

        def traced():
            holder["before"] = replays()
            holder["r"] = replay_trace(head, call, clients=TRAFFIC_CLIENTS,
                                       speed=1.0, timeout_s=TRAFFIC_TIMEOUT_S)

        records = _kernel_records(torch, traced, names=names, warm=warm,
                                  where="traffic_trace")
        before, after = holder["before"], replays()
        check(sorted(before) == sorted(after)
              and bert.stats()["rejoins"] == gpt2.stats()["rejoins"] == 0,
              f"traffic_trace: a program was built during the trace "
              f"(new {sorted(set(after) - set(before))}; rejoins "
              f"{bert.stats()['rejoins']} / {gpt2.stats()['rejoins']})")
        ran = {k: after[k] - before.get(k, 0) for k in after}
        statuses = {r["status"] for r in holder["r"][0]}
        check(statuses <= {"ok", "shed", "deadline"},
              f"traffic_trace: statuses {statuses}")
    finally:
        check(srv.stop(timeout=120), "traffic_trace: server did not stop")
    L = lm.num_layers
    fam = {f: sum(n for k, n in ran.items() if k[0] in fs)
           for f, fs in (("bucket", ("bucket",)), ("decode", ("decode",)),
                         ("verify", ("verify", "verify_batch")))}
    want = {"flash_attention_fwd": 24 * fam["bucket"],
            "ragged_paged_attention": L * fam["decode"],
            "ragged_paged_verify": L * fam["verify"]}
    check(records == want and fam["bucket"] and fam["decode"],
          f"traffic_trace: the traced replay ran {records} B1/B4/B5 "
          f"kernels; its graph replays hold {want}")
    check(counted == [k.launches for k in kernels],
          "traffic_trace: a wrapper launched outside a graph")
    emit("traffic_trace", replicas=ctx["replicas"],
         requests=len(head.requests), kernel_records=records,
         replays=fam, ok=sum(r["status"] == "ok" for r in holder["r"][0]),
         wall_s=holder["r"][1])
    return records


# ------------------------------------------------------------- artifact
# the artifact phase's small classifier, exported on the CPU and loaded on
# the card: 2 layers, head dim 64 (4 heads of 256 units), L = 128
ARTIFACT_SMALL = dict(vocab_size=30522, units=256, hidden_size=1024,
                      num_layers=2, num_heads=4, max_length=512)
# logits of an artifact against its exporting module's forward on the
# card: the same kernels at the same shapes, so bit for bit is expected
# (reported); held to 1e-5 of max|logit| for the loaded program's other
# op order around them
ARTIFACT_MOVE_TOL = 1e-5
ARTIFACT_TRACE_REPLAYS = 10


def _flash_nodes(module):
    """B1 operator nodes in a loaded program's graph."""
    return sum(1 for n in module.graph.nodes if n.op == "call_function"
               and "mxnet_tpu_torch.flash_attention_fwd" in str(n.target))


def _export_bert(torch, dev, tmp):
    """``predict``'s seed-0 ``BERTClassifier`` exported with
    ``dynamic_batch=True`` from batch-1 examples into ``tmp``: (module,
    artifact path, export seconds)."""
    from mxnet_tpu_torch import deploy
    clf = _bert_classifier(torch, dev, 0)
    L = PREDICT_L
    example = (np.zeros((1, L), np.int32), np.zeros((1, L), np.int32),
               np.full((1,), L, np.int32))
    t0 = time.perf_counter()
    path = deploy.export_stablehlo(clf, *example,
                                   path=os.path.join(tmp, "bert"),
                                   dynamic_batch=True)
    return clf, path, time.perf_counter() - t0


def _small_classifier(torch):
    """The ``ARTIFACT_SMALL`` classifier on the CPU, seed 2, eval."""
    from mxnet_tpu_torch.models import torch_bert as models
    bert = models.BERTModel(**ARTIFACT_SMALL, dropout=0.0, use_flash=True,
                            device="cpu",
                            generator=torch.Generator().manual_seed(2))
    return models.BERTClassifier(bert, num_classes=2, dropout=0.0).eval()


def _artifact_moved(torch, dev, clients):
    """A small classifier (``ARTIFACT_SMALL``) exported on the CPU and
    loaded with ``device="cuda"``: its lengths' ``aten.to`` and weights
    move to the card, and its logits on the first 8 requests match its
    CUDA twin's eager forward."""
    import copy

    from mxnet_tpu_torch import deploy
    small = _small_classifier(torch)
    twin = copy.deepcopy(small).to(dev)
    reqs = [r for c in clients for r in c][:8]
    tmp = tempfile.mkdtemp(prefix="artifact_small_")
    try:
        path = deploy.export_stablehlo(small, *reqs[0],
                                       path=os.path.join(tmp, "small"),
                                       dynamic_batch=True)
        model = deploy.load_stablehlo(path, device=dev)
        devices = deploy._artifact_devices(model.exported)
        check(devices == {dev}, f"artifact: the CPU export still names "
                                f"{devices} after the move")
        err = scale = 0.0
        bitwise = True
        with torch.no_grad():
            for req in reqs:
                got = model.call(*req).cpu().numpy()
                want = twin(*(torch.from_numpy(a).to(dev) for a in req)) \
                    .cpu().numpy()
                err = max(err, float(np.abs(got - want).max()))
                scale = max(scale, float(np.abs(want).max()))
                bitwise &= bool(np.array_equal(got, want))
        check(err <= ARTIFACT_MOVE_TOL * scale,
              f"artifact: the CPU export loaded on the card is off its "
              f"CUDA twin by {err} (max|logit| {scale})")
        nodes = _flash_nodes(model.module)
        check(nodes == ARTIFACT_SMALL["num_layers"],
              f"artifact: {nodes} B1 nodes in the small export")
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    return dict(max_abs_err=err, max_abs_logit=scale, bitwise_equal=bitwise,
                requests=len(reqs), b1_nodes=nodes)


def _b1_dispatch_us(torch, dev, calls=200):
    """Host microseconds per eager B1 call at ``predict``'s bucket-16
    shape (fp32, BH 256, L 128, D 64): the wrapper called directly and
    through its registered operator (what ``_Flash`` calls since the
    artifact path), ``calls`` calls each after 20 warm-up calls, in
    turns (wrapper, operator, operator, wrapper), the device synchronised
    before and after each run.  The launches here compare two routes and
    are not the path's."""
    from mxnet_tpu_torch.ops import flash_attention as fa
    g = torch.Generator(device=dev).manual_seed(0)
    q, k, v = (torch.randn(256, PREDICT_L, 64, device=dev, generator=g)
               for _ in range(3))
    lens = torch.full((256,), PREDICT_L, dtype=torch.int32, device=dev)
    routes = {"wrapper": fa.flash_attention_fwd,
              "operator": fa.flash_attention_fwd_op}
    times = {name: [] for name in routes}
    for name in ("wrapper", "operator", "operator", "wrapper"):
        fn = routes[name]
        for _ in range(20):
            fn(q, k, v, lens, False, 0.125, -1)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(calls):
            fn(q, k, v, lens, False, 0.125, -1)
        times[name].append((time.perf_counter() - t0) / calls * 1e6)
        torch.cuda.synchronize()
    return {name: float(np.mean(t)) for name, t in times.items()}


def phase_artifact(torch, dev):
    """The artifact path: ``predict``'s seed-0 ``BERTClassifier`` (fp32,
    ``use_flash=True``, depth not cut) exported on the card with
    ``deploy.export_stablehlo(dynamic_batch=True)`` (a ``torch.export``
    program, B1 one operator node per layer), loaded into a fresh
    ``ModelRepository`` with ``load_artifact`` and served by a fresh
    ``ModelServer`` with ``predict``'s config: ``prewarm`` captures the
    five buckets, then ``predict``'s traffic.  Every response within
    ``PREDICT_TOL`` of the exporting module's eager forward; 24 B1 nodes
    in the served graph; 5 programs, none built after prewarm; fewer
    batches than requests; the B1 wrapper counts 24 per capture (zeroed
    just before the load, read after the traffic).  Then a small
    classifier exported on the CPU, loaded on the card.  The server and
    the artifact's files are freed before the phase returns."""
    from mxnet_tpu_torch import runtime_metrics as rm
    from mxnet_tpu_torch.ops import flash_attention as fa
    from mxnet_tpu_torch.serving import (ModelRepository, ModelServer,
                                         ServingConfig, bucket_set)
    t_phase = time.perf_counter()
    clients = _predict_traffic(BERT_LARGE["vocab_size"])
    rows = sum(r[0].shape[0] for c in clients for r in c)
    n_req = sum(len(c) for c in clients)
    tmp = tempfile.mkdtemp(prefix="artifact_")
    srv = None
    try:
        clf, path, export_s = _export_bert(torch, dev, tmp)
        art_bytes = os.path.getsize(path)
        want = _eager_logits(torch, dev, clf, clients)
        del clf
        _free(torch)
        cfg = ServingConfig(max_batch_size=PREDICT_MAX_BATCH,
                            num_workers=PREDICT_WORKERS,
                            max_latency_us=2000)
        fa.flash_attention_fwd.launches = 0
        t0 = time.perf_counter()
        repo = ModelRepository()
        entry = repo.load_artifact("bert", path, device=dev)
        load_s = time.perf_counter() - t0
        srv = ModelServer(repo, cfg)
        t0 = time.perf_counter()
        warm = srv.prewarm("bert")
        prewarm_s = time.perf_counter() - t0
        progs = _entry_programs(srv, entry)
        check(sorted(progs) == bucket_set(PREDICT_MAX_BATCH)
              and warm["compiled"] == len(progs) == 5,
              f"artifact: prewarm built {warm}")
        capture_s = {b: p.capture_s for b, p in sorted(progs.items())}
        nodes = _flash_nodes(progs[1].module)
        check(nodes == BERT_LARGE["num_layers"],
              f"artifact: {nodes} B1 operator nodes in the served graph, "
              f"want {BERT_LARGE['num_layers']}")
        check(len({id(p.module) for p in progs.values()}) == 1,
              "artifact: the buckets do not share one loaded module")
        del progs
        st0 = srv.stats()
        rm.reset()
        rm.enable()
        try:
            got, wall = _run_clients(srv, clients)
        finally:
            rm.disable()
        st1 = srv.stats()
        occupancy = rm.SERVING_BATCH_OCCUPANCY.sum() \
            / max(1, rm.SERVING_BATCH_OCCUPANCY.count())
        rm.reset()
        launches = fa.flash_attention_fwd.launches
        check(launches == 24 * 5,
              f"artifact: {launches} B1 launches for 5 captures (24 each: "
              f"the eager warm-up before each capture)")
        err, scale = _predict_err(got, want)
        tol = PREDICT_TOL * scale
        check(err <= tol, f"artifact: served logits differ from the "
                          f"exporting module's eager forward by {err} "
                          f"(tolerance {tol})")
        bitwise = all(np.array_equal(g, w) for g_c, w_c in zip(got, want)
                      for (g, *_), w in zip(g_c, w_c))
        batches = st1["batches"] - st0["batches"]
        check(batches < n_req, f"artifact: {batches} batches for {n_req} "
                               f"requests: nothing coalesced")
        check(st1["programs"] == 5 and
              st1["bucket_misses"] == st0["bucket_misses"],
              f"artifact: {st1['programs']} programs, a bucket built "
              f"after prewarm: {st1['bucket_misses'] - st0['bucket_misses']}")
        lat = sorted(tb - ta for c in got for _y, ta, tb in c)
    finally:
        if srv is not None:
            check(srv.stop(timeout=120), "artifact: the server did not stop")
        shutil.rmtree(tmp, ignore_errors=True)
    del srv, repo, entry
    _free(torch)
    moved = _artifact_moved(torch, dev, clients)
    dispatch_us = _b1_dispatch_us(torch, dev)
    emit("artifact", requests=n_req, rows=rows, export_s=export_s,
         artifact_bytes=art_bytes, load_s=load_s, prewarm_s=prewarm_s,
         capture_s=capture_s, wall_s=wall, requests_per_s=n_req / wall,
         rows_per_s=rows / wall,
         latency_p50_ms=float(np.percentile(lat, 50)) * 1e3,
         latency_p99_ms=float(np.percentile(lat, 99)) * 1e3,
         batches=batches, mean_bucket_occupancy=occupancy,
         programs=st1["programs"], b1_nodes=nodes,
         max_abs_err_vs_eager=err, max_abs_logit=scale, tolerance=tol,
         bitwise_equal=bitwise, b1_launches=launches, cpu_export=moved,
         b1_host_us_per_call=dispatch_us,
         seconds=time.perf_counter() - t_phase)
    return {"launches": launches}


def _traced_replays(torch, prog, padded, where, tags=()):
    """``ARTIFACT_TRACE_REPLAYS`` calls of bucket program ``prog`` on
    ``padded`` traced with ``torch.profiler``, after 3 untraced ones and
    a warm-up one in the trace: exactly 24 B1 kernel records per replay and no B1 wrapper count (the
    graph launches the kernel).  Returns the last untraced output, the B1
    records, the device kernels per replay and the device ms per replay
    by family: ``b1``, ``gemm``, each tag of ``tags`` (kernel-name
    substrings) and ``other``."""
    from mxnet_tpu_torch.ops import flash_attention as fa
    for _ in range(3):
        (out,) = prog(*padded)
    counted = fa.flash_attention_fwd.launches
    b1 = FLASH_NAMES["flash_attention_fwd"]
    with _profiled(torch, warm=lambda: prog(*padded), where=where) as prof:
        for _ in range(ARTIFACT_TRACE_REPLAYS):
            prog(*padded)
    fam = dict.fromkeys(("b1", "gemm", *tags, "other"), 0.0)
    records = kernels = 0
    for evt in prof.key_averages():
        us = _kernel_us(evt, torch)
        if us is None:
            continue
        key = evt.key.lower()
        kernels += evt.count
        if b1 in evt.key:
            records += evt.count
            fam["b1"] += us
        elif any(t in key for t in GEMM_TAGS):
            fam["gemm"] += us
        else:
            fam[next((t for t in tags if t in key), "other")] += us
    check(records == 24 * ARTIFACT_TRACE_REPLAYS,
          f"{where}: {records} B1 records over {ARTIFACT_TRACE_REPLAYS} "
          f"replays (24 each)")
    check(fa.flash_attention_fwd.launches == counted,
          f"{where}: B1 launched outside the graph")
    n = ARTIFACT_TRACE_REPLAYS
    return out, records, kernels / n, {k: v / n / 1e3
                                       for k, v in fam.items()}


def phase_artifact_trace(torch, dev):
    """A traced rerun of the artifact path's bucket-16 replays: the
    seed-0 classifier exported and loaded again (the ``artifact`` phase
    freed its own before training), bucket 16 built, then
    ``ARTIFACT_TRACE_REPLAYS`` replays of ``predict``'s first six
    requests padded to 16 rows traced with ``torch.profiler``: exactly 24
    B1 kernel records per replay and no wrapper count (the graph
    launches the kernel, not the plain version); the replayed logits
    against the exporting module's eager forward on the same batch."""
    from mxnet_tpu_torch.serving import ModelRepository, pad_batch
    clients = _predict_traffic(BERT_LARGE["vocab_size"])
    padded, _ = pad_batch([r for c in clients for r in c][:6],
                          PREDICT_MAX_BATCH)
    tmp = tempfile.mkdtemp(prefix="artifact_trace_")
    try:
        clf, path, _ = _export_bert(torch, dev, tmp)
        with torch.no_grad():
            want = clf(*(torch.from_numpy(a).to(dev) for a in padded)) \
                .cpu().numpy()
        del clf
        _free(torch)
        entry = ModelRepository().load_artifact("bert", path, device=dev)
        prog = entry.make_program(PREDICT_MAX_BATCH)
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    got, records, _kernels, fam = _traced_replays(torch, prog, padded,
                                                  "artifact_trace")
    err = float(np.abs(got - want).max())
    scale = float(np.abs(want).max())
    check(err <= PREDICT_TOL * scale,
          f"artifact_trace: bucket-16 logits off the eager forward by {err}")
    emit("artifact_trace", replays=ARTIFACT_TRACE_REPLAYS,
         b1_kernel_records=records,
         b1_records_per_replay=records / ARTIFACT_TRACE_REPLAYS,
         device_ms_per_replay=sum(fam.values()),
         bucket16_max_abs_err=err)
    del prog, entry
    _free(torch)
    return {"records": records, "replays": ARTIFACT_TRACE_REPLAYS}


# ------------------------------------------------------- artifact_quant
QUANT_MODES = ("int8", "fp8")
# the calibration batch: the first rows of predict's traffic
QUANT_CALIB_ROWS = 8
# device ms of a bucket replay: median of this many, CUDA events
QUANT_REPLAYS = 20
# the reference's unseen-batch bound on a quantized artifact's error
# against its float module (tests/test_export_stablehlo.py:340-344):
# within QUANT_ERR_FACTOR x the manifest's max_abs_err + QUANT_ERR_SLACK
QUANT_ERR_FACTOR = 10.0
QUANT_ERR_SLACK = 1e-3
# kernel-name tags of the dequantization's elementwise passes: the
# multiply by the scale (int8 widened inside it) and fp8's widening copy
DEQUANT_TAGS = ("mulfunctor", "direct_copy")


def _calib_batch(clients, rows=QUANT_CALIB_ROWS):
    """The first ``rows`` rows of ``predict``'s traffic as one batch."""
    reqs = [r for c in clients for r in c]
    return tuple(np.concatenate([r[i] for r in reqs])[:rows]
                 for i in range(3))


def _replay_ms(timer, torch, prog, iters=QUANT_REPLAYS):
    """Device ms of one replay of bucket program ``prog``'s graph on its
    own stream (``Timer``: median over ``iters``, CUDA events)."""
    with prog._lock, torch.cuda.stream(prog.stream):
        return timer(prog.graph.replay, iters=iters, warmup=2)


def _serve_artifact(torch, dev, timer, path, clients, cfg, want_f32, tag):
    """``path`` loaded by ``load_artifact`` into a fresh repository and
    served by a fresh ``ModelServer`` (``cfg``): prewarm (5 captures,
    memory around it, each pool's bytes), ``predict``'s traffic, the B1
    wrapper count (zeroed just before the load: 24 per capture), bucket-1
    and bucket-16 replay device ms; every response within
    ``PREDICT_TOL``·max|logit| of the loaded program's eager call on the
    request alone, and its error against the float module's eager logits
    ``want_f32``.  Returns (readings, server, repository, entry, the
    loaded program's eager logits); the server keeps running."""
    from mxnet_tpu_torch import runtime_metrics as rm
    from mxnet_tpu_torch.ops import flash_attention as fa
    from mxnet_tpu_torch.serving import (ModelRepository, ModelServer,
                                         bucket_set)
    n_req = sum(len(c) for c in clients)
    rows = sum(r[0].shape[0] for c in clients for r in c)
    fa.flash_attention_fwd.launches = 0
    t0 = time.perf_counter()
    repo = ModelRepository()
    entry = repo.load_artifact("bert", path, device=dev, version=1)
    load_s = time.perf_counter() - t0
    srv = ModelServer(repo, cfg)
    torch.cuda.synchronize()
    mem0 = torch.cuda.memory_allocated(), torch.cuda.memory_reserved()
    t0 = time.perf_counter()
    warm = srv.prewarm("bert")
    prewarm_s = time.perf_counter() - t0
    torch.cuda.synchronize()
    mem1 = torch.cuda.memory_allocated(), torch.cuda.memory_reserved()
    progs = _entry_programs(srv, entry)
    check(sorted(progs) == bucket_set(PREDICT_MAX_BATCH)
          and warm["compiled"] == len(progs) == 5,
          f"{tag}: prewarm built {warm}")
    nodes = _flash_nodes(progs[1].module)
    check(nodes == BERT_LARGE["num_layers"],
          f"{tag}: {nodes} B1 operator nodes in the served graph")
    pools = {b: {"allocated_bytes": _pool_bytes(torch, p.pool),
                 "reserved_bytes": _pool_reserved(torch, p.pool)}
             for b, p in sorted(progs.items())}
    st0 = srv.stats()
    rm.reset()
    rm.enable()
    try:
        got, wall = _run_clients(srv, clients)
    finally:
        rm.disable()
    st1 = srv.stats()
    rm.reset()
    launches = fa.flash_attention_fwd.launches
    check(launches == 24 * 5,
          f"{tag}: {launches} B1 launches for 5 captures (24 each)")
    batches = st1["batches"] - st0["batches"]
    check(batches < n_req,
          f"{tag}: {batches} batches for {n_req} requests")
    check(st1["programs"] == 5
          and st1["bucket_misses"] == st0["bucket_misses"],
          f"{tag}: {st1['programs']} programs, a bucket built after "
          f"prewarm")
    replay_ms = {b: _replay_ms(timer, torch, progs[b])
                 for b in (1, PREDICT_MAX_BATCH)}
    want = _eager_logits(torch, dev, progs[1].module, clients)
    del progs
    err, scale = _predict_err(got, want)
    tol = PREDICT_TOL * scale
    check(err <= tol, f"{tag}: served logits off the loaded program's "
                      f"eager call by {err} (tolerance {tol})")
    err_f32, scale_f32 = _predict_err(got, want_f32)
    lat = sorted(tb - ta for c in got for _y, ta, tb in c)
    readings = dict(
        load_s=load_s, prewarm_s=prewarm_s,
        capture_s={b: p.capture_s for b, p in
                   sorted(_entry_programs(srv, entry).items())},
        requests_per_s=n_req / wall, rows_per_s=rows / wall,
        latency_p50_ms=float(np.percentile(lat, 50)) * 1e3,
        latency_p99_ms=float(np.percentile(lat, 99)) * 1e3,
        batches=batches, programs=st1["programs"], b1_nodes=nodes,
        b1_launches=launches,
        prewarm_memory={"allocated_bytes": mem1[0] - mem0[0],
                        "reserved_bytes": mem1[1] - mem0[1]},
        graph_pools=pools,
        pools_reserved_bytes=sum(p["reserved_bytes"]
                                 for p in pools.values()),
        replay_device_ms=replay_ms, max_abs_err_vs_program=err,
        tolerance=tol, max_abs_err_vs_f32_module=err_f32,
        max_abs_logit=scale_f32)
    return readings, srv, repo, entry, want


def _quantize_core_on_card(torch, dev):
    """``mxnet_tpu_torch.quantize`` on the card against its CPU run on
    the same inputs, for int8 and fp8: per-tensor (a weight-sized
    tensor, and fp8 at scale 1 over values past +-464) and blockwise
    payloads and scales bit for bit, dequantized values equal."""
    from mxnet_tpu_torch import quantize as qz
    rs = np.random.RandomState(0)
    w = (rs.randn(1024, 1024) * 0.05).astype(np.float32)
    wide = np.linspace(-600, 600, 1 << 16, dtype=np.float32)
    same = {}
    for mode in QUANT_MODES:
        spec = qz.CompressionSpec(mode)
        scale = qz.tensor_scale(w, spec)
        check(scale == qz.tensor_scale(torch.from_numpy(w).to(dev), spec),
              f"artifact_quant: the {mode} tensor scale differs on the card")
        cases = [(w, scale)] + ([(wide, 1.0)] if mode == "fp8" else [])
        for x, s in cases:
            cpu = qz.quantize_tensor(x, s, spec, device="cpu")
            card = qz.quantize_tensor(x, s, spec, device=dev)
            check(torch.equal(cpu.view(torch.uint8),
                              card.cpu().view(torch.uint8)),
                  f"artifact_quant: the {mode} payload differs on the card")
            check(torch.equal(
                qz.dequantize_tensor(cpu, s, torch.float32).nan_to_num(),
                qz.dequantize_tensor(card, s, torch.float32).cpu()
                .nan_to_num()),
                f"artifact_quant: {mode} dequantization differs on the card")
        block = qz.CompressionSpec(mode, block=128)
        p_cpu, s_cpu = qz.quantize(w, block, device="cpu")
        p_card, s_card = qz.quantize(w, block, device=dev)
        check(torch.equal(s_cpu, s_card.cpu()) and torch.equal(
            p_cpu.view(torch.uint8), p_card.cpu().view(torch.uint8)),
            f"artifact_quant: blockwise {mode} differs on the card")
        same[mode] = True
    return same


def _artifact_moved_quant(torch, dev, clients, mode):
    """A small classifier (``ARTIFACT_SMALL``) exported ``mode`` on the
    CPU and loaded on the card, against its twin exported on the card
    from the same weights: the same payloads and scales, and logits on
    the first 8 requests within ``ARTIFACT_MOVE_TOL``·max|logit|."""
    import copy

    from mxnet_tpu_torch import deploy
    small = _small_classifier(torch)
    twin = copy.deepcopy(small).to(dev)
    reqs = [r for c in clients for r in c][:8]
    tmp = tempfile.mkdtemp(prefix="artifact_quant_small_")
    try:
        paths = [deploy.export_stablehlo(m, *reqs[0],
                                         path=os.path.join(tmp, name),
                                         dynamic_batch=True, quantize=mode)
                 for m, name in ((small, "cpu"), (twin, "cuda"))]
        moved, native = (deploy.load_stablehlo(p, device=dev) for p in paths)
        devices = deploy._artifact_devices(moved.exported)
        check(devices == {dev}, f"artifact_quant: the CPU {mode} export "
                                f"still names {devices} after the move")
        same = moved.quantization["weights"] \
            == native.quantization["weights"] and all(
                torch.equal(moved.exported.state_dict[w["name"]].view(
                    torch.uint8), native.exported.state_dict[w["name"]]
                    .view(torch.uint8))
                for w in moved.quantization["weights"])
        err = scale = 0.0
        with torch.no_grad():
            for req in reqs:
                got = moved.call(*req).cpu().numpy()
                want = native.call(*req).cpu().numpy()
                err = max(err, float(np.abs(got - want).max()))
                scale = max(scale, float(np.abs(want).max()))
        check(err <= ARTIFACT_MOVE_TOL * scale,
              f"artifact_quant: the CPU {mode} export loaded on the card "
              f"is off its CUDA twin by {err} (max|logit| {scale})")
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    return dict(max_abs_err=err, max_abs_logit=scale,
                payloads_and_scales_equal=bool(same), requests=len(reqs))


def phase_artifact_quant(torch, dev, timer):
    """Quantized artifacts: ``predict``'s seed-0 ``BERTClassifier`` (fp32,
    ``use_flash=True``, depth not cut, L = 128) exported on the card with
    ``dynamic_batch=True`` as float32 and with ``quantize="int8"`` and
    ``"fp8"`` (manifest v4: 101 weights of the mode's dtype, a 64-hex
    digest), calibrated on the first 8 rows of ``predict``'s traffic;
    each quantized artifact below a third of the float one's bytes.  Each
    of the three is loaded by ``load_artifact`` into a fresh repository
    and served by a fresh ``ModelServer`` with ``predict``'s config and
    traffic (``_serve_artifact``: 24 B1 nodes, 120 B1 wrapper launches,
    5 programs, responses against the loaded program's eager calls);
    each quantized response within ``QUANT_ERR_FACTOR`` x the manifest's
    ``max_abs_err`` + ``QUANT_ERR_SLACK`` of the float module's eager
    logits.  On the float artifact's server, the int8 artifact of the
    same model is registered as version 2, prewarmed and swapped in under
    traffic: each response matches the version that admitted it.  Then a
    small classifier exported quantized on the CPU, loaded on the card,
    and ``quantize``'s core on the card against its CPU run.  Returns the artifact paths (kept for ``artifact_quant_trace``) and
    the B1 wrapper counts."""
    from mxnet_tpu_torch import deploy
    from mxnet_tpu_torch.serving import ServingConfig
    t_phase = time.perf_counter()
    clients = _predict_traffic(BERT_LARGE["vocab_size"])
    calib = _calib_batch(clients)
    tmp = tempfile.mkdtemp(prefix="artifact_quant_")
    clf = _bert_classifier(torch, dev, 0)
    paths, export_s, art_bytes, manifests = {}, {}, {}, {}
    for mode in ("f32",) + QUANT_MODES:
        t0 = time.perf_counter()
        paths[mode] = deploy.export_stablehlo(
            clf, *calib, path=os.path.join(tmp, mode), dynamic_batch=True,
            quantize=None if mode == "f32" else mode)
        torch.cuda.synchronize()
        export_s[mode] = time.perf_counter() - t0
        art_bytes[mode] = os.path.getsize(paths[mode])
        manifests[mode] = deploy.load_manifest(paths[mode])
    want_f32 = _eager_logits(torch, dev, clf, clients)
    n_params = sum(p.numel() for p in clf.parameters())
    n_quant = sum(p.numel() for p in clf.parameters() if p.dim() >= 2)
    del clf
    _free(torch)
    for mode in QUANT_MODES:
        qb = manifests[mode]["quantization"]
        wire = "int8" if mode == "int8" else "float8_e4m3fn"
        check(manifests[mode]["manifest_version"] == 4
              and qb["mode"] == mode and len(qb["weights"]) == 101
              and all(w["dtype"] == wire for w in qb["weights"])
              and sum(w["elems"] for w in qb["weights"]) == n_quant
              and len(qb["digest"]) == 64
              and int(qb["digest"], 16) >= 0
              and qb["calibration"]["examples"] == QUANT_CALIB_ROWS,
              f"artifact_quant: the {mode} manifest: "
              f"{ {k: v for k, v in qb.items() if k != 'weights'} }")
        check(3 * art_bytes[mode] < art_bytes["f32"],
              f"artifact_quant: the {mode} artifact holds "
              f"{art_bytes[mode]} bytes, the float one {art_bytes['f32']}")
    cfg = ServingConfig(max_batch_size=PREDICT_MAX_BATCH,
                        num_workers=PREDICT_WORKERS, max_latency_us=2000)
    served, want_q = {}, {}
    for mode in QUANT_MODES:
        served[mode], srv, _repo, _entry, want_q[mode] = _serve_artifact(
            torch, dev, timer, paths[mode], clients, cfg, want_f32,
            f"artifact_quant[{mode}]")
        check(srv.stop(timeout=120), "artifact_quant: a server did not stop")
        calib_err = manifests[mode]["quantization"]["calibration"]
        bound = QUANT_ERR_FACTOR * calib_err["max_abs_err"] \
            + QUANT_ERR_SLACK
        served[mode]["f32_module_err_bound"] = bound
        check(served[mode]["max_abs_err_vs_f32_module"] <= bound,
              f"artifact_quant: {mode} responses off the float module by "
              f"{served[mode]['max_abs_err_vs_f32_module']} (bound {bound})")
        del srv, _repo, _entry
        _free(torch)
    # the float artifact, then the int8 one swapped in over it
    served["f32"], srv, repo, _entry, want_f32_prog = _serve_artifact(
        torch, dev, timer, paths["f32"], clients, cfg, want_f32,
        "artifact_quant[f32]")
    try:
        def register_v2():
            entry2 = repo.load_artifact("bert", paths["int8"], device=dev,
                                        version=2, activate=False)
            check(entry2.quantization["mode"] == "int8",
                  "artifact_quant: version 2 lost its quantization block")

        hot_swap = _hot_swap(srv, repo, clients, register_v2,
                             want_f32_prog, want_q["int8"],
                             served["int8"]["tolerance"],
                             "artifact_quant")
    finally:
        check(srv.stop(timeout=120), "artifact_quant: the server did not "
                                     "stop")
    del srv, repo, _entry
    _free(torch)
    moved = {mode: _artifact_moved_quant(torch, dev, clients, mode)
             for mode in QUANT_MODES}
    core = _quantize_core_on_card(torch, dev)
    launches = {mode: served[mode]["b1_launches"]
                for mode in ("f32",) + QUANT_MODES}
    emit("artifact_quant", requests=sum(len(c) for c in clients),
         rows=sum(r[0].shape[0] for c in clients for r in c),
         parameters=n_params, quantized_parameters=n_quant,
         export_s=export_s, artifact_bytes=art_bytes,
         calibration={m: manifests[m]["quantization"]["calibration"]
                      for m in QUANT_MODES},
         served=served, hot_swap_f32_to_int8=hot_swap, cpu_export=moved,
         core_bitwise_vs_cpu=core,
         seconds=time.perf_counter() - t_phase)
    return {"tmp": tmp, "paths": paths, "launches": launches,
            "replay_ms": {m: served[m]["replay_device_ms"]
                          for m in served}}


def phase_artifact_quant_trace(torch, dev, ctx):
    """A traced rerun of the quantized artifacts' bucket-16 replays: the
    float, int8 and fp8 artifacts of ``artifact_quant`` (kept on disk)
    loaded again, bucket 16 built for each, then
    ``ARTIFACT_TRACE_REPLAYS`` replays of ``predict``'s first six requests
    padded to 16 rows traced with ``torch.profiler``: exactly 24 B1
    kernel records per replay and no wrapper count; the device ms per
    replay by kernel family (B1, GEMMs, the dequantization's multiply
    and widening copy, the rest) and the dequantization's ms per replay
    (the mode's dequantization families less the float program's).
    Removes the artifacts' files."""
    from mxnet_tpu_torch.serving import ModelRepository, pad_batch
    clients = _predict_traffic(BERT_LARGE["vocab_size"])
    padded, _ = pad_batch([r for c in clients for r in c][:6],
                          PREDICT_MAX_BATCH)
    out, records_all = {}, 0
    try:
        for mode in ("f32",) + QUANT_MODES:
            entry = ModelRepository().load_artifact(
                "bert", ctx["paths"][mode], device=dev)
            prog = entry.make_program(PREDICT_MAX_BATCH)
            _out, records, kernels, fam = _traced_replays(
                torch, prog, padded, f"artifact_quant_trace[{mode}]",
                tags=DEQUANT_TAGS)
            out[mode] = dict(
                b1_kernel_records=records, kernels_per_replay=kernels,
                device_ms_per_replay=sum(fam.values()), by_family_ms=fam)
            records_all += records
            del prog, entry
            _free(torch)
    finally:
        shutil.rmtree(ctx["tmp"], ignore_errors=True)

    def dequant(mode):
        return sum(out[mode]["by_family_ms"][t] for t in DEQUANT_TAGS)
    for mode in QUANT_MODES:
        out[mode]["dequant_ms_per_replay"] = dequant(mode) - dequant("f32")
        out[mode]["extra_ms_per_replay"] = \
            out[mode]["device_ms_per_replay"] \
            - out["f32"]["device_ms_per_replay"]
    emit("artifact_quant_trace", replays=ARTIFACT_TRACE_REPLAYS, modes=out)
    return {"records": records_all,
            "replays": ARTIFACT_TRACE_REPLAYS * len(out)}


# ----------------------------------------------------------------- train
def phase_train_parity(torch, dev):
    """BERT-large ``BERTForPretrain``, fp32, dropout 0: the flash path
    (kernels B1-B3) against the dense additive-mask path on the same
    weights and batch — loss and every parameter gradient."""
    from mxnet_tpu_torch.models import torch_bert as models
    V = BERT_LARGE["vocab_size"]
    dense = models.BERTForPretrain(models.bert_24_1024_16(
        dropout=0.0, device=dev, generator=torch.Generator().manual_seed(0)))
    flash = models.BERTForPretrain(models.bert_24_1024_16(
        dropout=0.0, use_flash=True, device="meta"))
    flash.to_empty(device=dev)
    flash.load_state_dict(dense.state_dict())
    feats, labels = _train_batch(V)
    tf = [torch.from_numpy(a).to(dev) for a in feats]
    tl = [torch.from_numpy(a).to(dev) for a in labels]
    out = {}
    for name, head in (("dense", dense), ("flash", flash)):
        params = [p for _, p in head.named_parameters()]
        loss = models.pretrain_loss(head(*tf), *tl)
        grads = torch.autograd.grad(loss, params)
        out[name] = (float(loss.detach()), grads)
        del loss
    torch.cuda.synchronize()
    names = [n for n, _ in dense.named_parameters()]
    (l_d, g_d), (l_f, g_f) = out["dense"], out["flash"]
    check(abs(l_f - l_d) <= 1e-4 * abs(l_d),
          f"train_parity: flash loss {l_f} vs dense {l_d}")
    # 1e-3 of each tensor's max|grad|: 24 fp32 layers, attention summed
    # in another order (online softmax vs dense softmax), TF32 off
    worst = (0.0, "")
    for n, a, b in zip(names, g_f, g_d):
        ratio = float((a - b).abs().max()) / max(float(b.abs().max()),
                                                  1e-30)
        worst = max(worst, (ratio, n))
    check(worst[0] <= 1e-3, f"train_parity: gradient of {worst[1]} off by "
                            f"{worst[0]} of its max")
    emit("train_parity", model="bert_24_1024_16", dtype="float32",
         batch=int(feats[0].shape[0]), seq_len=int(feats[0].shape[1]),
         valid_lengths=feats[2].astype(int).tolist(),
         masked_per_row=int(feats[3].shape[1]), loss_dense=l_d,
         loss_flash=l_f, worst_grad_rel_err=worst[0],
         worst_grad_tensor=worst[1], grad_tensors=len(names))
    del dense, out, g_d, g_f
    return flash, feats, labels


TRAIN_MODES = ("eager", "graphs")
# graph replays of the training step that train_graphs traces per dtype
TRACED_REPLAYS = 3


def _flops_6nbl(trainer, B, L):
    """The rule the port's ``step_flops`` replaced, printed beside its
    count: 6 * trainable parameters * B * L plus 12 * B * L^2 * units per
    attention layer.  It counts the word embedding and the MLM decoder as
    dense work at every position (the decoder runs at the masked ones)."""
    n = sum(p.numel() for k, p in trainer.params.items()
            if k in trainer.trainable)
    return 6.0 * n * B * L + 12.0 * B * L * L * BERT_LARGE["units"] \
        * BERT_LARGE["num_layers"]


def _flash_counters():
    from mxnet_tpu_torch.ops import flash_attention as fa
    return (fa.flash_attention_fwd, fa.flash_attention_bwd_dq,
            fa.flash_attention_bwd_dkv)


def _trainer(torch, head, feats, dtype, mode, dev="cuda"):
    from mxnet_tpu_torch import parallel
    from mxnet_tpu_torch.models import torch_bert as models
    return parallel.ShardedTrainer(
        head, models.pretrain_loss, parallel.make_mesh(dp=1, device=dev),
        optimizer="adamw", optimizer_params={"learning_rate": 1e-4},
        example_inputs=feats, n_labels=2,
        dtype=None if dtype == "float32" else torch.bfloat16,
        graphs=mode == "graphs")


def _free(torch):
    import gc
    gc.collect()
    torch.cuda.synchronize()
    torch.cuda.empty_cache()


def phase_train(torch, dev, head, feats, labels):
    """``ShardedTrainer.step`` on BERT-large with ``use_flash=True``, fp32
    then bf16, eager (``graphs=False``) and graphs (the default: one CUDA
    graph per batch signature) from the same weights: 2 warm-up steps
    each (graphs: the first is eager and captured, the second the first
    replay), then 10 timed adamw steps each, in turns of 5 (eager,
    graphs, graphs, eager).  The flash kernels' counters are zeroed just
    before each step and read just after it: an eager step launches
    each of B1-B3 once per layer; in graph mode the first step does so
    and a replay calls no wrapper.  Returns those launches summed by
    dtype and mode (the graphs trainers' are the main path's).  Memory: ``max_memory_allocated`` from just before
    each trainer is built through its warm-up steps, and that peak less
    what was allocated before the trainer (the other mode's trainer,
    the model); what the trainer holds allocated and reserved after
    them, and the graph pool's live bytes.  FLOPs: ``ShardedTrainer.step_flops`` (counted from the
    step), with the old 6NBL rule beside it."""
    from mxnet_tpu_torch import perf_account
    kernels = _flash_counters()
    layers = BERT_LARGE["num_layers"]
    batch = feats + labels
    B, L = feats[0].shape
    peak = perf_account.detect_peak_tflops()
    results, keep = {}, None
    # wrapper launches by dtype and mode, each step's counted alone
    tally = {dtype: {mode: dict.fromkeys(FLASH_NAMES, 0)
                     for mode in TRAIN_MODES}
             for dtype in ("float32", "bfloat16")}

    def counted_step(tr, mode, losses, dtype):
        i = len(losses)
        for kern in kernels:
            kern.launches = 0
        losses.append(tr.step(*batch))
        rose = [kern.launches for kern in kernels]
        for kern in kernels:
            tally[dtype][mode][kern.__name__] += kern.launches
        want = layers if mode == "eager" or i == 0 else 0
        check(rose == [want] * 3,
              f"train {dtype} {mode} step {i}: flash launches rose by "
              f"{rose}, want {want} each")

    for dtype in ("float32", "bfloat16"):
        trainers, losses, rows = {}, {m: [] for m in TRAIN_MODES}, {}
        for mode in TRAIN_MODES:
            torch.cuda.synchronize()
            base = torch.cuda.memory_allocated()
            held = torch.cuda.memory_reserved()
            torch.cuda.reset_peak_memory_stats()
            trainers[mode] = tr = _trainer(torch, head, feats, dtype, mode)
            for _ in range(2):
                counted_step(tr, mode, losses[mode], dtype)
            torch.cuda.synchronize()
            top = torch.cuda.max_memory_allocated()
            rows[mode] = dict(
                max_memory_allocated_gb=top / 1e9,
                trainer_peak_gb=(top - base) / 1e9,
                trainer_allocated_gb=(torch.cuda.memory_allocated() - base)
                / 1e9,
                trainer_reserved_gb=(torch.cuda.memory_reserved() - held)
                / 1e9,
                graph_pool_gb=_pool_bytes(torch, tr._graph_pool) / 1e9)
        turns = {m: [] for m in TRAIN_MODES}
        for mode in TRAIN_MODES + TRAIN_MODES[::-1]:
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            for _ in range(5):
                counted_step(trainers[mode], mode, losses[mode], dtype)
            torch.cuda.synchronize()
            turns[mode].append((time.perf_counter() - t0) / 5)
        flops = trainers["graphs"].step_flops(*batch)
        old = _flops_6nbl(trainers["graphs"], B, L)
        check(flops == trainers["eager"].step_flops(*batch),
              "train: the two modes' step FLOPs differ")
        for mode in TRAIN_MODES:
            tr = trainers[mode]
            dt = float(np.mean(turns[mode]))
            ls = [float(x) for x in losses[mode]]
            timed = ls[2:]
            check(all(np.isfinite(ls)), f"train {dtype} {mode}: loss {ls}")
            check(timed[-1] < timed[0], f"train {dtype} {mode}: loss did "
                                        f"not fall over the timed steps: "
                                        f"{timed}")
            rows[mode].update(
                ms_per_step=dt * 1e3,
                ms_per_step_turns=[t * 1e3 for t in turns[mode]],
                samples_per_s=B / dt, tflops_per_s=flops / dt / 1e12,
                mfu_vs_bf16_peak=flops / dt / (peak * 1e12) if peak
                else None,
                loss_step1=timed[0], loss_step10=timed[-1], losses=ls)
            if mode == "graphs":
                rows[mode].update(compiled=tr.compiled,
                                  capture_s=tr.capture_seconds)
        # free-running, reported: the two modes' runs are compared by
        # train_graphs step by step
        results[dtype] = dict(
            step_flops=flops, step_flops_6nbl_rule=old,
            rule_over_count=old / flops,
            kernel_launches=tally[dtype],
            losses_max_rel_diff_graphs_vs_eager=max(
                abs(g - e) / abs(e) for g, e in zip(rows["graphs"]["losses"],
                                                    rows["eager"]["losses"])),
            **rows)
        if dtype == "bfloat16":
            keep = (trainers, {m: rows[m]["ms_per_step"]
                               for m in TRAIN_MODES})
        del trainers
        _free(torch)
    emit("train", model="bert_24_1024_16", use_flash=True, batch=int(B),
         seq_len=int(L), optimizer="adamw", learning_rate=1e-4,
         peak_tflops=peak, launches_per_eager_step_each=layers, **results)
    return tally, keep, batch


def _snapshot(trainer):
    """Every tensor a step writes: parameters, buffers and the
    optimizer state (the step count included), by name."""
    st = trainer.opt_state
    return {**{("p", n): t for n, t in trainer.params.items()},
            **{("b", n): t for n, t in trainer.buffers.items()},
            **{("m", n): t for n, t in st["mean"].items()},
            **{("v", n): t for n, t in st["var"].items()},
            ("step",): st["step"]}


def _dropout_replays(torch, dev, feats, labels, dropout):
    """Two replays of one captured step from the same state: a
    two-layer BERT at BERT-large widths with ``dropout``, a graphs
    trainer's first step (eager, captured), a snapshot of its state,
    a replay, the snapshot copied back in place, a replay.  Returns the
    two replays' losses and the graph's replay count."""
    from mxnet_tpu_torch.models import torch_bert as models
    head = models.BERTForPretrain(models.bert_24_1024_16(
        dropout=dropout, num_layers=2, use_flash=True, device=dev,
        generator=torch.Generator().manual_seed(1)))
    tr = _trainer(torch, head, feats, "float32", "graphs")
    batch = feats + labels
    tr.step(*batch)
    state = _snapshot(tr)
    saved = {k: t.detach().clone() for k, t in state.items()}
    first = float(tr.step(*batch))
    with torch.no_grad():
        for k, t in state.items():
            t.copy_(saved[k])
    second = float(tr.step(*batch))
    replays = sum(p.replays for p in tr._programs.values())
    return first, second, replays


def _param_err(a, b):
    """(worst error over the parameters of trainer ``a`` against ``b``
    as a share of each tensor's max|w|, its name, all bitwise equal)."""
    worst, same = (-1.0, ""), True
    for n, p in b.params.items():
        g, p = a.params[n].detach(), p.detach()
        same = same and bool((g == p).all())
        err = float((g.float() - p.float()).abs().max()) / max(
            float(p.float().abs().max()), 1e-30)
        worst = max(worst, (err, n))
    return worst[0], worst[1], same


def phase_train_graphs(torch, dev, head, feats, labels):
    """The training step's CUDA graph against the eager step on the
    card, from the same BERT-large weights, 3 steps in fp32 and bf16.
    Before each step the eager trainer's whole state (parameters,
    buffers, moments, step count) is copied in place into the graphs
    trainer, so every step of the two starts from the same state (the
    restore that the graphs' fixed addresses call for); each step's
    loss is held to 1e-6 relative in fp32 and 1e-3 in bf16, and in fp32
    every parameter after it to 1e-5 of its tensor's max|w|; bitwise
    equality is reported.  A second eager trainer stepping alongside
    from the same weights, never synchronised, gives the eager path's
    own repeatability (reported): the embeddings' weight gradient is a
    sorted segment sum (``models/torch_bert.py``), so it is expected bit for
    bit; PyTorch's own embedding backward of the two-row token-type
    table was not, and AdamW turns a rounding difference in a zero
    gradient (the key bias's, exactly zero in exact arithmetic) into a
    step of ``lr``.  ``TRACED_REPLAYS`` traced replays hold ``num_layers`` kernel
    records each of B1, B2 and B3 per replay (B2/B3 launched by autograd
    on the capturing stream) and the wrappers count nothing; returns
    those records and replays by dtype.  Dropout: with p = 0.1 two replays
    from one state (restored in place) draw other masks and give other
    losses; with p = 0 the same two replays give the same loss.  Runs
    after the timed and traced phases it would otherwise disturb (it
    traces replays)."""
    kernels = _flash_counters()
    layers = BERT_LARGE["num_layers"]
    batch = feats + labels
    out = {}
    for dtype in ("float32", "bfloat16"):
        te, te2, tg = (_trainer(torch, head, feats, dtype, mode)
                       for mode in ("eager", "eager", "graphs"))
        rows = []
        for i in range(3):
            src, dst = _snapshot(te), _snapshot(tg)
            with torch.no_grad():
                for k, t in dst.items():
                    t.copy_(src[k])
            lg, le, le2 = (float(t.step(*batch)) for t in (tg, te, te2))
            rel = abs(lg - le) / abs(le)
            err, name, same = _param_err(tg, te)
            err2, name2, _ = _param_err(te2, te)
            rows.append(dict(loss_graphs=lg, loss_eager=le,
                             loss_rel_err=rel, loss_bitwise_equal=lg == le,
                             worst_param_rel_err=err, worst_param=name,
                             params_bitwise_equal=same,
                             free_eager_loss=le2,
                             free_eager_worst_param_rel_err=err2,
                             free_eager_worst_param=name2))
            if dtype == "float32":
                check(rel <= 1e-6 and err <= 1e-5,
                      f"train_graphs fp32 step {i}: loss {lg} vs eager "
                      f"{le}, parameter {name} off by {err} of its max")
            else:
                check(rel <= 1e-3, f"train_graphs bf16 step {i}: loss {lg} "
                                   f"vs eager {le}")
        counted = [k.launches for k in kernels]
        take = {}

        def traced():
            take["replays"] = sum(p.replays for p in tg._programs.values())
            for _ in range(TRACED_REPLAYS):
                tg.step(*batch)

        records = _kernel_records(torch, traced, FLASH_NAMES,
                                  warm=lambda: tg.step(*batch),
                                  where=f"train_graphs {dtype}")
        ran = (sum(p.replays for p in tg._programs.values())
               - take["replays"])
        check(ran == TRACED_REPLAYS
              and records == dict.fromkeys(FLASH_NAMES, layers * ran),
              f"train_graphs {dtype}: {ran} traced replays ran {records} "
              f"flash kernels, want {layers} each per replay")
        check(counted == [k.launches for k in kernels],
              f"train_graphs {dtype}: a wrapper counted a replayed kernel")
        out[dtype] = dict(steps=rows, traced_replays=ran,
                          traced_replay_kernel_records=records,
                          compiled=tg.compiled,
                          capture_s=tg.capture_seconds)
        del te, te2, tg
        _free(torch)
    # p = 0 is the control: the restore is exact and a replay repeats
    # (within 1e-6, bitwise reported), so a difference at p = 0.1 ten
    # times larger comes from the masks
    a0, b0, n0 = _dropout_replays(torch, dev, feats, labels, 0.0)
    check(n0 == 2 and abs(a0 - b0) <= 1e-6 * abs(b0),
          f"train_graphs: two replays with dropout 0 from one state gave "
          f"{a0} and {b0}")
    a, b, n = _dropout_replays(torch, dev, feats, labels, 0.1)
    check(n == 2 and a != b and abs(a - b) > 10 * abs(a0 - b0),
          f"train_graphs: two replays with dropout 0.1 from one state "
          f"gave {a} and {b}: the mask is frozen")
    _free(torch)
    emit("train_graphs", model="bert_24_1024_16", **out,
         dropout_replay_losses={"0.1": [a, b], "0.0": [a0, b0]},
         dropout_0_bitwise_equal=a0 == b0)
    return {dtype: dict(records=o["traced_replay_kernel_records"],
                        replays=o["traced_replays"])
            for dtype, o in out.items()}


def phase_profile_train(torch, trainers, batch, step_ms):
    """Where one bf16 ``ShardedTrainer.step`` of BERT-large goes, eager
    and as a graph replay: 3 steps of each traced with
    ``torch.profiler``: device time by family (B1, B2, B3, GEMMs,
    other), kernels and host calls (kernel and graph launches, copies)
    per step, and the device idle share against the untraced step time
    (``train``'s, taken before any trace).  Each traced step must hold
    ``num_layers`` kernel records each of B1-B3 in both modes, and the
    forward, dQ and dK/dV families must come from the tensor-core
    (``wgmma``) kernels alone."""
    families = tuple(("flash_" + name[len("flash_attention_"):], tag)
                     for name, tag in FLASH_NAMES.items())
    n = 3
    rows = {}
    for mode in TRAIN_MODES:
        trainer = trainers[mode]
        trainer.step(*batch)
        torch.cuda.synchronize()
        with _profiled(torch, warm=lambda: trainer.step(*batch),
                       where=f"profile_train {mode}") as prof:
            t0 = time.perf_counter()
            for _ in range(n):
                trainer.step(*batch)
            torch.cuda.synchronize()
            profiled_ms = (time.perf_counter() - t0) / n * 1e3
        split = {name: 0.0 for name, _ in families}
        split.update(gemm=0.0, other=0.0)
        names = {name: [] for name, _ in families}
        records = {name: 0 for name, _ in families}
        kernels, host_calls, top = 0, 0, []
        for evt in prof.key_averages():
            us = _kernel_us(evt, torch)
            if not us:
                if _is_host_call(evt.key):
                    host_calls += evt.count
                continue
            key = evt.key.lower()
            kernels += evt.count
            top.append((us, evt.count, evt.key[:90]))
            fam = next((name for name, tag in families if tag in key), None)
            if fam is None:
                fam = "gemm" if any(t in key for t in GEMM_TAGS) else "other"
            else:
                names[fam].append(evt.key[:90])
                records[fam] += evt.count
            split[fam] += us
        busy_ms = sum(split.values()) / 1e3 / n
        layers = BERT_LARGE["num_layers"]
        check(records == {name: layers * n for name, _ in families},
              f"profile_train {mode}: {n} traced steps ran {records} flash "
              f"kernels, want {layers} each per step")
        # the bf16 step ran the tensor-core kernels, and only them
        for fam, _ in families:
            check(split[fam] > 0 and names[fam] and all(
                "wgmma" in k for k in names[fam]),
                f"profile_train {mode}: bf16 {fam} ran {names[fam]} "
                f"({split[fam]} us), not the wgmma kernel")
        rows[mode] = dict(
            step_ms_host=step_ms[mode], step_ms_host_profiled=profiled_ms,
            device_ms_per_step=busy_ms if busy_ms else None,
            device_ms_per_step_by_family={k: v / n / 1e3
                                          for k, v in split.items()}
            if busy_ms else None,
            device_idle_share=(1.0 - busy_ms / step_ms[mode])
            if busy_ms else None,
            kernel_launches_per_step=kernels / n if busy_ms else None,
            host_calls_per_step=host_calls / n,
            flash_kernel_records=records,
            family_kernels=names,
            top_kernels=[dict(kernel=k, ms_per_step=us / n / 1e3,
                              launches_per_step=c / n)
                         for us, c, k in sorted(top, reverse=True)[:8]])
    emit("profile_train", dtype="bfloat16", steps_traced=n, **rows)


# ------------------------------------------------------------ durability
# The supervised BERT-large runs: an NDArrayIter over 48 rows made like
# the training batch, 12 steps, a verified checkpoint every 4 (max_to_keep
# 2).  The faulted run's 7th step call fails, and the restore that follows
# finds step 4 corrupted and falls back to the step-0 anchor; its 17th
# call (step 10 of the replay) stalls past the deadline and restores step 8.
DURABILITY_ROWS, DURABILITY_STEPS, DURABILITY_SAVE_EVERY = 48, 12, 4
DURABILITY_B, DURABILITY_ITER_SEED = 8, 11
DURABILITY_SPEC = ("train.step=fail,after=6,times=1;"
                   "checkpoint.restore=corrupt,times=1;"
                   "train.step=stall,after=16,times=1,ms={stall_ms:.0f}")
DURABILITY_FIRED = {"train.step:fail": 1, "checkpoint.restore:corrupt": 1,
                    "train.step:stall": 1}
# the step deadline: 20 graph steps, and at least 1 s
DEADLINE_STEPS, DEADLINE_MIN_MS = 20, 1000.0
# the stalled step sleeps through the rest of the faulted run (a restore,
# 4 steps and a save: less than the uninterrupted run's 4 saves) and the
# readings taken after it: the uninterrupted run's seconds plus this
STALL_MARGIN_S = 5.0
# faulted losses against the uninterrupted run's (train_graphs' bf16 rule)
DURABILITY_LOSS_RTOL = 1e-3
# the watchdog's cost: graph steps a turn, in turns off, on, on, off
WATCHDOG_TURN_STEPS = 10
# the SIGTERM children: 2 layers at BERT-large widths, bf16, a verified
# checkpoint every step; the signalled child waits for the signal between
# two steps once it has completed SIGNAL_AT
SIGNAL_STEPS, SIGNAL_AT, SIGNAL_LAYERS = 4, 2, 2
# durability's two supervised trainers: BERT-large widths at this depth
# (each save and restore moves the whole state: 24 layers took 5.3-5.9 s
# a save, and the phase ~115 s of the script's 1200 s)
DURABILITY_LAYERS = 4
CHILD_TIMEOUT_S = 300


def _sync(torch, dev):
    if torch.device(dev).type == "cuda":
        torch.cuda.synchronize()


def _bits(t):
    """``t`` viewed as integers of its width, for bitwise comparison."""
    import torch
    return t.detach().contiguous().view(
        {1: torch.uint8, 2: torch.int16, 4: torch.int32,
         8: torch.int64}[t.element_size()])


def _state_diff(trainer, clone):
    """The tensors of ``_snapshot(trainer)`` that are not bitwise equal to
    ``clone``'s (a clone of an earlier snapshot)."""
    return [str(k) for k, t in _snapshot(trainer).items()
            if not bool((_bits(t) == _bits(clone[k])).all())]


def _durability_data(model_kw):
    """``DURABILITY_ROWS`` rows made as ``_train_batch`` makes the
    training batch (``RandomState(0)``), as lists of numpy arrays."""
    vocab = model_kw.get("vocab_size", BERT_LARGE["vocab_size"])
    L = model_kw.get("max_length", BERT_LARGE["max_length"])
    feats, labels = _train_batch(vocab, B=DURABILITY_ROWS, L=L, seed=0)
    return list(feats), list(labels)


def _durability_iter(model_kw, batch_size):
    from mxnet_tpu_torch import io
    feats, labels = _durability_data(model_kw)
    return io.NDArrayIter(feats, labels, batch_size=batch_size,
                          shuffle=True, seed=DURABILITY_ITER_SEED)


def _durability_trainer(torch, dev, example, model_kw, dtype="bfloat16",
                        dropout=0.0, num_layers=None, seed=0):
    """A graphs ``ShardedTrainer`` (adamw, lr 1e-4) over a new
    ``BERTForPretrain`` on ``bert_24_1024_16`` (``model_kw`` overrides its
    widths; the card runs BERT-large's) from ``seed``."""
    from mxnet_tpu_torch.models import torch_bert as models
    kw = dict(model_kw)
    if num_layers is not None:
        kw["num_layers"] = num_layers
    head = models.BERTForPretrain(models.bert_24_1024_16(
        dropout=dropout, use_flash=True, device=dev,
        generator=torch.Generator().manual_seed(seed), **kw))
    return _trainer(torch, head, example, dtype, "graphs", dev)


class _LogCount(logging.Handler):
    """The port's warnings that contain ``needle``."""

    def __init__(self, needle):
        super().__init__(logging.WARNING)
        self.needle, self.hits = needle, []

    def emit(self, record):
        msg = record.getMessage()
        if self.needle in msg:
            self.hits.append(msg)


def _timed(fn, seconds):
    """``fn`` that appends the seconds of each call to ``seconds``."""
    def call(*args, **kwargs):
        t0 = time.perf_counter()
        try:
            return fn(*args, **kwargs)
        finally:
            seconds.append(time.perf_counter() - t0)
    return call


def _filesystem(path):
    """The type and free bytes of the filesystem that holds ``path``."""
    st = os.statvfs(path)
    kind = subprocess.run(["stat", "-f", "-c", "%T", path],
                          capture_output=True, text=True).stdout.strip()
    return dict(dir=path, fs_type=kind, free_bytes=st.f_bavail * st.f_frsize)


def _dir_bytes(path):
    return sum(os.path.getsize(os.path.join(d, f))
               for d, _, files in os.walk(path) for f in files)


def _watchdog_threads():
    return {t for t in threading.enumerate()
            if t.name.startswith("mxnet-watchdog")}


def _replays(trainer):
    return sum(p.replays for p in trainer._programs.values())


def _supervised(torch, dev, trainer, root, name, model_kw, spec=None):
    """One supervised run of ``DURABILITY_STEPS`` steps from the warmed
    ``trainer``, checkpointing into ``root/name``, under the fault
    ``spec``; every restore is timed."""
    from mxnet_tpu_torch import faults, parallel
    it = _durability_iter(model_kw, DURABILITY_B)
    mngr = parallel.CheckpointManager(os.path.join(root, name),
                                      max_to_keep=2, async_write=True)
    restores = []
    mngr.restore = _timed(mngr.restore, restores)
    sup = parallel.TrainingSupervisor(
        trainer, mngr, it, save_every=DURABILITY_SAVE_EVERY, backoff_ms=1,
        backoff_max_ms=2)
    plan = faults.install(spec) if spec else None
    t0 = time.perf_counter()
    try:
        losses = [float(v) for v in sup.run(DURABILITY_STEPS)]
    finally:
        faults.clear()
    _sync(torch, dev)
    return dict(sup=sup, mngr=mngr, losses=losses, restores=restores,
                seconds=time.perf_counter() - t0,
                fired=plan.counters() if plan else {})


def _watchdog_turns(torch, dev, trainer, batch, deadline_ms):
    """Host ms per graph step with the watchdog off and on, in turns
    (off, on, on, off) of ``WATCHDOG_TURN_STEPS`` steps each."""
    from mxnet_tpu_torch.parallel import StepWatchdog
    dogs = {"off": StepWatchdog(timeout_ms=0, slow_factor=0),
            "on": StepWatchdog(timeout_ms=deadline_ms, slow_factor=0)}
    turns = {"off": [], "on": []}
    for mode in ("off", "on", "on", "off"):
        trainer.watchdog = dogs[mode]
        _sync(torch, dev)
        t0 = time.perf_counter()
        for _ in range(WATCHDOG_TURN_STEPS):
            trainer.step(*batch)
        _sync(torch, dev)
        turns[mode].append((time.perf_counter() - t0)
                           / WATCHDOG_TURN_STEPS * 1e3)
    return {m: dict(ms_per_step=float(np.mean(v)), turns_ms=v)
            for m, v in turns.items()}


def _round_trip(torch, dev, trainer, batch, root):
    """The checkpoint's own contract on the card: a save, a step that
    changes the state, a restore of that save; every restored tensor must
    be bitwise equal to what the save read.  Returns the phases'
    seconds, the bytes of the step directory and of the pinned staging
    buffers."""
    from mxnet_tpu_torch import parallel
    mngr = parallel.CheckpointManager(os.path.join(root, "round_trip"),
                                      max_to_keep=1, async_write=True)
    saved = {k: t.detach().clone() for k, t in _snapshot(trainer).items()}
    t0 = time.perf_counter()
    mngr.save(1, trainer)
    save_return_s = time.perf_counter() - t0
    mngr.wait()
    save_s = time.perf_counter() - t0
    staging = list(mngr._staging.values())
    saves = dict(mngr.timings)
    trainer.step(*batch)
    check(_state_diff(trainer, saved), "durability: a step changed no state")
    t0 = time.perf_counter()
    mngr.restore(trainer, step=1)
    _sync(torch, dev)
    restore_s = time.perf_counter() - t0
    diff = _state_diff(trainer, saved)
    check(not diff, f"durability: {len(diff)} restored tensors differ from "
                    f"what the save read, first {diff[:3]}")
    out = dict(save_s=save_s, save_return_s=save_return_s,
               save_phases_s={k: saves[k] for k in
                              ("snapshot_s", "write_s", "hash_s",
                               "barrier_s")},
               restore_s=restore_s,
               restore_phases_s={k: mngr.timings[k] for k in
                                 ("verify_s", "read_s", "copy_s")},
               step_dir_bytes=_dir_bytes(mngr._step_dir(1)),
               state_bytes=sum(t.numel() * t.element_size()
                               for t in saved.values()),
               state_tensors=len(saved),
               staging_bytes=sum(b.numel() * b.element_size()
                                 for b in staging),
               staging_pinned=all(b.is_pinned() for b in staging))
    mngr.close()
    return out


def phase_durability(torch, dev, feats, labels, step_ms, model_kw=None):
    """``TrainingSupervisor.run`` over the captured bf16 BERT-large step
    (B1-B3 replayed in its graph), twice from the same seed and the same
    warm-up step (the signature's capture, taken before any deadline is
    armed): uninterrupted, then under ``DURABILITY_SPEC`` with the step
    deadline armed (``DEADLINE_STEPS`` graph steps of ``train``'s, at
    least ``DEADLINE_MIN_MS``).  The faulted run must restart twice (the
    kill, the stall's ``TrainStepTimeoutError``), time out once, fall back
    once from the corrupted step 4, and end with the uninterrupted run's
    12 losses within ``DURABILITY_LOSS_RTOL``.  While the stalled step
    still sleeps: the watchdog's cost per graph step, in turns, and a
    save / step / restore round trip that must give back every tensor the
    save read, bit for bit, both on the uninterrupted trainer.  Then the
    stalled step is released: it must not replay, and the faulted
    trainer's state must not change.  The flash wrappers' counters are
    zeroed before the trainers are built and read after the faulted run
    (each capture's eager step).  Returns what ``durability_trace``
    needs."""
    from mxnet_tpu_torch.parallel import StepWatchdog
    model_kw = model_kw or {}
    kernels = _flash_counters()
    warm = tuple(feats) + tuple(labels)
    root = tempfile.mkdtemp(prefix="mxnet-durability-")
    fs = _filesystem(root)
    deadline_ms = max(DEADLINE_MIN_MS, DEADLINE_STEPS * step_ms)
    fallbacks = _LogCount("falling back")
    logging.getLogger("mxnet_tpu_torch").addHandler(fallbacks)
    try:
        for kern in kernels:
            kern.launches = 0
        trainers = {}
        for run in ("reference", "faulted"):
            trainers[run] = tr = _durability_trainer(torch, dev, feats,
                                                     model_kw)
            tr.step(*warm)
        ref = _supervised(torch, dev, trainers["reference"], root,
                          "reference", model_kw)
        ref["mngr"].close()
        shutil.rmtree(os.path.join(root, "reference"))
        stall_ms = (ref["seconds"] + STALL_MARGIN_S) * 1e3
        tr = trainers["faulted"]
        tr.watchdog = StepWatchdog(timeout_ms=deadline_ms, slow_factor=0)
        before = _watchdog_threads()
        got = _supervised(torch, dev, tr, root, "faulted", model_kw,
                          DURABILITY_SPEC.format(stall_ms=stall_ms))
        launches = {k.__name__: k.launches for k in kernels}
        stalled = [t for t in _watchdog_threads() - before if t.is_alive()]
        replays = _replays(tr)
        frozen = {k: t.detach().clone() for k, t in _snapshot(tr).items()}
        sup = got["sup"]
        check(got["fired"] == DURABILITY_FIRED,
              f"durability: faults fired {got['fired']}, want "
              f"{DURABILITY_FIRED}")
        check(sup.restarts == 2 and tr.watchdog.timeouts == 1
              and len(got["restores"]) == 2,
              f"durability: {sup.restarts} restarts, "
              f"{tr.watchdog.timeouts} timeouts, {len(got['restores'])} "
              f"restores; want 2, 1, 2")
        check(len(fallbacks.hits) == 1,
              f"durability: {len(fallbacks.hits)} fallbacks from a corrupt "
              f"step, want 1: {fallbacks.hits}")
        check(len(stalled) == 1, f"durability: {len(stalled)} stalled "
                                 f"steps alive after the run, want 1")
        want, have = ref["losses"], got["losses"]
        check(len(want) == len(have) == DURABILITY_STEPS,
              f"durability: {len(want)} and {len(have)} losses")
        rel = [abs(a - b) / abs(b) for a, b in zip(have, want)]
        check(max(rel) <= DURABILITY_LOSS_RTOL,
              f"durability: faulted losses {have} vs uninterrupted {want}")
        # readings on the uninterrupted trainer while the step sleeps
        rt = trainers.pop("reference")
        watchdog = _watchdog_turns(torch, dev, rt, warm, deadline_ms)
        contract = _round_trip(torch, dev, rt, warm, root)
        del rt, ref["sup"]
        t0 = time.perf_counter()
        stalled[0].join(stall_ms / 1e3 + 60)
        waited_s = time.perf_counter() - t0
        check(not stalled[0].is_alive(), "durability: the stalled step "
                                         "never woke")
        diff = _state_diff(tr, frozen)
        check(_replays(tr) == replays and not diff,
              f"durability: the released step replayed "
              f"{_replays(tr) - replays} times and changed {diff[:3]}")
        del frozen
        _free(torch)
        layers = model_kw.get("num_layers", BERT_LARGE["num_layers"])
        check(all(n == 2 * layers for n in launches.values()),
              f"durability: flash wrappers launched {launches}, want "
              f"{2 * layers} each (two captures)")
        state = sup.debug_state()
        emit("durability", model="bert_24_1024_16", num_layers=layers,
             dtype="bfloat16", graphs=True, batch=DURABILITY_B,
             rows=DURABILITY_ROWS,
             steps=DURABILITY_STEPS, save_every=DURABILITY_SAVE_EVERY,
             max_to_keep=2, filesystem=fs, spec=DURABILITY_SPEC.format(
                 stall_ms=stall_ms), fired=got["fired"],
             deadline_ms=deadline_ms, graph_step_ms=step_ms,
             restarts=sup.restarts, timeouts=tr.watchdog.timeouts,
             fallbacks=fallbacks.hits, losses_uninterrupted=want,
             losses_faulted=have, losses_max_rel_err=max(rel),
             losses_bitwise_equal=have == want,
             run_seconds={"uninterrupted": ref["seconds"],
                          "faulted": got["seconds"]},
             restore_seconds_per_restart=got["restores"],
             faulted_manager_last_timings_s=dict(got["mngr"].timings),
             recovery_seconds_total=state["recovery_seconds_total"],
             stalled_step_waited_s=waited_s,
             released_step_replays=_replays(tr) - replays,
             watchdog=watchdog, round_trip=contract,
             launches=launches)
        return dict(trainer=tr, sup=sup, mngr=got["mngr"], root=root,
                    launches=launches, layers=layers)
    except BaseException:
        shutil.rmtree(root, ignore_errors=True)
        raise
    finally:
        logging.getLogger("mxnet_tpu_torch").removeHandler(fallbacks)


def phase_durability_trace(torch, ctx):
    """``TRACED_REPLAYS`` more steps of the faulted run's supervisor (its
    watchdog still armed, and its durable finish save at the end) under
    ``torch.profiler``: ``num_layers`` kernel records each of B1, B2 and
    B3 per replay, and no wrapper count.  Frees the trainer and the
    checkpoints."""
    kernels = _flash_counters()
    tr, sup = ctx["trainer"], ctx["sup"]
    layers = ctx["layers"]
    try:
        counted = [k.launches for k in kernels]
        replays = _replays(tr)
        records = _kernel_records(
            torch, lambda: sup.run(DURABILITY_STEPS + TRACED_REPLAYS),
            FLASH_NAMES)
        ran = _replays(tr) - replays
        check(ran == TRACED_REPLAYS
              and records == dict.fromkeys(FLASH_NAMES, layers * ran),
              f"durability_trace: {ran} supervised replays ran {records} "
              f"flash kernels, want {layers} each per replay")
        check(counted == [k.launches for k in kernels],
              "durability_trace: a wrapper counted a replayed kernel")
        ctx["mngr"].close()
        emit("durability_trace", replays=ran, kernel_records=records,
             latest_verified_step=ctx["mngr"].latest_verified_step())
        return records
    finally:
        shutil.rmtree(ctx["root"], ignore_errors=True)


def phase_durability_rng(torch, dev, feats, model_kw=None):
    """The RNG half of a bit-exact resume on the card: a two-layer BERT at
    BERT-large widths with dropout 0.1, fp32, graphs, supervised for 4
    steps (verified checkpoints at 0, 2 and 4, each with the supervisor's
    extra payload: RNG state, cursor, losses).  Step 2 is restored in
    place, its RNG state and cursor set back, and step 3 taken again: its
    loss must be bitwise equal to the first step 3's, since the replay
    reads the restored CUDA generator's seed and offset.  Step 2 restored
    again without its RNG state: step 3 must differ (other masks)."""
    from mxnet_tpu_torch import parallel, random
    model_kw = model_kw or {}
    tr = _durability_trainer(torch, dev, feats, model_kw, dtype="float32",
                             dropout=0.1, num_layers=2, seed=1)
    it = _durability_iter(model_kw, DURABILITY_B)
    root = tempfile.mkdtemp(prefix="mxnet-durability-rng-")
    try:
        mngr = parallel.CheckpointManager(root, max_to_keep=3)
        random.seed(5)
        sup = parallel.TrainingSupervisor(tr, mngr, it, save_every=2,
                                          backoff_ms=1)
        losses = [float(v) for v in sup.run(4)]
        extra = mngr.load_extra(2)

        def step3(rng):
            mngr.restore(tr, step=2)
            if rng:
                random.set_state(extra["rng"])
            it.set_cursor(extra["cursor"])
            b = it.next()
            return float(tr.step(*b.data, *b.label))

        again, control = step3(True), step3(False)
        check(again == losses[2],
              f"durability_rng: step 3 after the restore gave {again}, "
              f"the first step 3 {losses[2]}")
        check(control != losses[2],
              f"durability_rng: step 3 without the RNG state gave the "
              f"first step 3's loss {control}: the masks did not move")
        mngr.close()
        emit("durability_rng", model="bert_24_1024_16", num_layers=2,
             dtype="float32", dropout=0.1, losses=losses,
             step3_restored=again, step3_without_rng=control,
             cuda_rng_in_extra="cuda" in extra["rng"],
             replays=_replays(tr))
    finally:
        shutil.rmtree(root, ignore_errors=True)
        del tr
        _free(torch)


class _AwaitSignal:
    """The supervisor's iterator in a ``durability_signal`` child: before
    each batch it prints the steps completed so far, and in the signalled
    child, once they reach ``SIGNAL_AT``, it waits there for the parent's
    SIGTERM — so the signal lands between two steps, where the step the
    handler stamps is the state it saves."""

    def __init__(self, it, completed, wait):
        self._it, self._completed, self._wait = it, completed, wait

    def next(self):
        k = self._completed()
        print(json.dumps({"step": k}), flush=True)
        if self._wait and k >= SIGNAL_AT:
            time.sleep(CHILD_TIMEOUT_S)
        return self._it.next()

    def reset(self):
        self._it.reset()

    def get_cursor(self):
        return self._it.get_cursor()

    def set_cursor(self, cursor):
        self._it.set_cursor(cursor)


def durability_child(ckdir, mode, build_dir, model_kw_json):
    """One ``durability_signal`` child (``mode`` plain, signal or resume):
    every kernel library from the persistent compile cache
    (``MXNET_COMPILE_CACHE_DIR``) into the empty ``build_dir``, no
    ``nvcc``; a two-layer bf16 BERT at BERT-large widths supervised to
    ``SIGNAL_STEPS`` steps into ``ckdir`` with a checkpoint every step
    (the resume child picks up what ``ckdir`` holds); the signal child
    installs ``save_on_signal`` with a step function that prints the step
    it stamps.  Prints JSON lines; the last one holds the losses."""
    import torch
    if not torch.cuda.is_available():
        return 1
    from mxnet_tpu_torch import parallel
    from mxnet_tpu_torch.ops import build
    t0 = time.perf_counter()
    build.BUILD_DIR = build_dir
    built = build.build()
    check(sorted(built) == sorted(build.SOURCES)
          and all(b["cached"] for b in built.values()),
          f"durability child: the kernels did not all come from the "
          f"compile cache: {({n: b['cached'] for n, b in built.items()})}")
    build_s = time.perf_counter() - t0
    model_kw = json.loads(model_kw_json)
    feats, _ = _durability_data(model_kw)
    tr = _durability_trainer(torch, torch.device("cuda:0"),
                             [a[:DURABILITY_B] for a in feats], model_kw,
                             num_layers=SIGNAL_LAYERS)
    mngr = parallel.CheckpointManager(ckdir, max_to_keep=2)
    sup = parallel.TrainingSupervisor(
        tr, mngr, _AwaitSignal(_durability_iter(model_kw, DURABILITY_B),
                               lambda: sup._step, mode == "signal"),
        save_every=1, backoff_ms=1)
    if mode == "signal":
        def stamp():
            print(json.dumps({"signal_step": sup._step}), flush=True)
            return sup._step
        mngr.save_on_signal(tr, stamp)
    losses = [float(v) for v in sup.run(SIGNAL_STEPS)]
    mngr.close()
    print(json.dumps({"losses": losses, "build_s": build_s,
                      "seconds": time.perf_counter() - t0}), flush=True)
    return 0


def _run_child(root, mode, ckdir, cache_dir, model_kw):
    """Run one child to its end (at most ``CHILD_TIMEOUT_S``); the signal
    child gets SIGTERM once it reports ``SIGNAL_AT`` completed steps."""
    import signal
    env = dict(os.environ, MXNET_COMPILE_CACHE_DIR=cache_dir)
    cmd = [sys.executable, os.path.abspath(__file__), "--durability-child",
           ckdir, mode, os.path.join(root, f"build-{mode}"),
           json.dumps(model_kw)]
    t0 = time.perf_counter()
    proc = subprocess.Popen(cmd, stdout=subprocess.PIPE, text=True, env=env)
    killer = threading.Timer(CHILD_TIMEOUT_S, proc.kill)
    killer.start()
    lines, signalled_at = [], None
    try:
        for line in proc.stdout:
            try:
                msg = json.loads(line)
            except ValueError:
                continue
            lines.append(msg)
            if mode == "signal" and signalled_at is None \
                    and msg.get("step", -1) >= SIGNAL_AT:
                signalled_at = msg["step"]
                proc.send_signal(signal.SIGTERM)
        rc = proc.wait()
    finally:
        killer.cancel()
        if proc.poll() is None:
            proc.kill()
            proc.wait()
    last = next((m for m in reversed(lines) if "losses" in m), {})
    return dict(rc=rc, seconds=time.perf_counter() - t0,
                signalled_at=signalled_at, losses=last.get("losses"),
                child_seconds=last.get("seconds"),
                build_s=last.get("build_s"),
                stamped=[m["signal_step"] for m in lines
                         if "signal_step" in m])


def phase_durability_signal(torch, cache_dir, model_kw=None):
    """Preemption on the card, in child processes (``durability_child``):
    an uninterrupted child; a child killed by SIGTERM once it reports
    step ``SIGNAL_AT``, whose ``save_on_signal`` handler saves the step
    it prints; a third child that auto-resumes from that directory to
    ``SIGNAL_STEPS``.  Gates: the signalled child's exit status is
    -SIGTERM, ``LATEST`` names the step its handler stamped (at least
    ``SIGNAL_AT``) and that step's manifest verifies; the resumed child's
    losses equal the uninterrupted child's within
    ``DURABILITY_LOSS_RTOL``.  Every child takes its kernels from the
    compile cache at ``cache_dir``."""
    import signal
    from mxnet_tpu_torch import parallel
    model_kw = model_kw or {}
    root = tempfile.mkdtemp(prefix="mxnet-durability-signal-")
    try:
        ck = os.path.join(root, "signalled")
        plain = _run_child(root, "plain", os.path.join(root, "plain"),
                           cache_dir, model_kw)
        check(plain["rc"] == 0 and plain["losses"]
              and len(plain["losses"]) == SIGNAL_STEPS,
              f"durability_signal: the uninterrupted child: {plain}")
        killed = _run_child(root, "signal", ck, cache_dir, model_kw)
        check(killed["rc"] == -signal.SIGTERM,
              f"durability_signal: the signalled child exited "
              f"{killed['rc']}, want {-signal.SIGTERM}")
        check(len(killed["stamped"]) == 1
              and killed["stamped"][0] >= SIGNAL_AT,
              f"durability_signal: the handler stamped {killed['stamped']}")
        step = killed["stamped"][0]
        mngr = parallel.CheckpointManager(ck)
        verdict = mngr._verify_step(step)
        check(mngr.latest_verified_step() == step
              and verdict == (True, "verified"),
              f"durability_signal: LATEST {mngr.latest_verified_step()}, "
              f"step {step}'s manifest {verdict}")
        step_bytes = _dir_bytes(mngr._step_dir(step))
        resumed = _run_child(root, "resume", ck, cache_dir, model_kw)
        check(resumed["rc"] == 0 and resumed["losses"]
              and len(resumed["losses"]) == SIGNAL_STEPS,
              f"durability_signal: the resumed child: {resumed}")
        rel = [abs(a - b) / abs(b)
               for a, b in zip(resumed["losses"], plain["losses"])]
        check(max(rel) <= DURABILITY_LOSS_RTOL,
              f"durability_signal: resumed losses {resumed['losses']} vs "
              f"uninterrupted {plain['losses']}")
        emit("durability_signal", model="bert_24_1024_16",
             num_layers=SIGNAL_LAYERS, dtype="bfloat16",
             steps=SIGNAL_STEPS, signalled_at=killed["signalled_at"],
             handler_step=step, latest_after_signal=step,
             latest_after_resume=mngr.latest_verified_step(),
             exit_status=killed["rc"], losses_uninterrupted=plain["losses"],
             losses_resumed=resumed["losses"], losses_max_rel_err=max(rel),
             losses_bitwise_equal=resumed["losses"] == plain["losses"],
             child_seconds={m: dict(wall=c["seconds"], run=c["child_seconds"],
                                    build_from_cache=c["build_s"])
                            for m, c in (("plain", plain),
                                         ("signalled", killed),
                                         ("resumed", resumed))},
             step_dir_bytes=step_bytes)
    finally:
        shutil.rmtree(root, ignore_errors=True)


# ---------------------------------------------------------------------------
# multi-rank training: torch.distributed jobs started by the port's launcher
# ---------------------------------------------------------------------------
DIST_STEPS = 3
DIST_LR = 1e-4
DIST_LOSS_RTOL = 1e-4          # dist_tp's losses vs the one-rank trainer
DIST_PARAM_ATOL = 3e-4         # three AdamW steps at lr 1e-4 move ~1e-4 each
DIST_INT8_FIRST_ATOL = 1e-4    # dist_dp_int8's first loss vs uncompressed
DIST_RING = dict(B=1, H=16, L=4096, D=64, window=512)
DIST_RING_ATOL = 1e-4
DIST_RING_GRAD_TOL = 1e-3      # of each gradient's max
DIST_JOB_TIMEOUT_S = 420
DIST_PROBE_TIMEOUT_S = 60


def _dist_out(outdir, job, rank, result):
    with open(os.path.join(outdir, f"{job}-{rank}.json"), "w") as f:
        json.dump(result, f)


def _dist_head(torch, dev, use_flash=True):
    """BERT-large ``BERTForPretrain`` (dropout 0) from seed 0 on ``dev``."""
    from mxnet_tpu_torch.models import torch_bert as models
    return models.BERTForPretrain(models.bert_24_1024_16(
        dropout=0.0, use_flash=use_flash, device=dev,
        generator=torch.Generator().manual_seed(0)))


def _dist_trainer(torch, head, mesh, feats, dtype, graphs, **kw):
    from mxnet_tpu_torch import parallel
    from mxnet_tpu_torch.models import torch_bert as models
    return parallel.ShardedTrainer(
        head, models.pretrain_loss, mesh, optimizer="adamw",
        optimizer_params={"learning_rate": DIST_LR}, example_inputs=feats,
        n_labels=2, dtype=dtype, graphs=graphs, **kw)


def _dist_counts(zero=False):
    counters = _flash_counters()
    if zero:
        for c in counters:
            c.launches = 0
    return {c.__name__: c.launches for c in counters}


def _timed_steps(torch, trainer, batch, n):
    """``n`` steps, each closed by a synchronize: (losses, ms per step)."""
    losses, ms = [], []
    for _ in range(n):
        t0 = time.perf_counter()
        loss = trainer.step(*batch)
        torch.cuda.synchronize()
        ms.append((time.perf_counter() - t0) * 1e3)
        losses.append(float(loss))
    return losses, ms


def _dist_nccl_worker(torch, dist, dev):
    """World 1 over NCCL: the host collectives, then a graphs trainer on
    ``make_mesh()`` over the group (its dp bucket all-reduce captured in
    the step graph) against the one-card graphs trainer, bf16."""
    from mxnet_tpu_torch import parallel
    dist.barrier("dist_nccl")
    red = dist.allreduce_host(np.array([2.5], np.float32)).tolist()
    b = dist.broadcast_host(torch.tensor([7.0], device=dev)).tolist()
    check(red == [2.5] and b == [7.0],
          f"dist_nccl: host collectives gave {red}, {b}")
    feats, labels = _train_batch(BERT_LARGE["vocab_size"])
    batch = (*feats, *labels)
    head = _dist_head(torch, dev)
    mesh = parallel.make_mesh()
    check(mesh.backend == "nccl" and mesh.groups is not None,
          f"dist_nccl: mesh {mesh}")
    one = _dist_trainer(torch, head, parallel.Mesh(dev), feats,
                        torch.bfloat16, True)
    grp = _dist_trainer(torch, head, mesh, feats, torch.bfloat16, True)
    check(grp._dp_group is not None and grp._buckets,
          "dist_nccl: the grouped trainer has no dp reduction")
    counts0 = _dist_counts(zero=True)
    torch.cuda.reset_peak_memory_stats()
    l_one, ms_one = _timed_steps(torch, one, batch, DIST_STEPS)
    l_grp, ms_grp = _timed_steps(torch, grp, batch, DIST_STEPS)
    launches = _dist_counts()
    check(l_grp == l_one, f"dist_nccl: losses {l_grp} vs the one-card "
                          f"graph trainer's {l_one}")
    # the eager first step and the capture each issued the step's bucket
    # all-reduces; a replay issues none from the host
    check(grp.collectives == 2 * len(grp._buckets),
          f"dist_nccl: {grp.collectives} dp collectives issued for "
          f"{len(grp._buckets)} buckets")
    # one more replay of each traced (after a warm-up one in the trace):
    # 24 of each of B1-B3 in both, and the grouped graph's extra kernels
    # (the float32 bucket pass; NCCL launches no kernel for an in-place
    # all-reduce of one rank)
    records = {}
    for name, tr in (("one", one), ("grouped", grp)):
        with _profiled(torch, warm=lambda: tr.step(*batch),
                       where=f"dist_nccl {name}") as prof:
            tr.step(*batch)
        rec = {"nccl": 0, "kernels": 0, **dict.fromkeys(FLASH_NAMES, 0)}
        for evt in prof.key_averages():
            if _kernel_us(evt, torch) is None:
                continue
            rec["kernels"] += evt.count
            if "nccl" in evt.key.lower():
                rec["nccl"] += evt.count
            for wrapper, tag in FLASH_NAMES.items():
                if tag in evt.key:
                    rec[wrapper] += evt.count
        records[name] = rec
    check(records["grouped"]["kernels"] > records["one"]["kernels"],
          f"dist_nccl: the grouped replay runs no reduction kernels: "
          f"{records}")
    check(all(records[k][w] == BERT_LARGE["num_layers"]
              for k in records for w in FLASH_NAMES),
          f"dist_nccl: B1-B3 records per replay {records}")
    bucket_bytes = 4 * (1 + sum(grp.params[n].numel()
                                for b in grp._buckets for n in b))
    return dict(losses_one_card=l_one, losses_grouped=l_grp,
                ms_per_step_one_card=ms_one, ms_per_step_grouped=ms_grp,
                compiled=grp.compiled, capture_s=grp.capture_seconds,
                buckets=len(grp._buckets), collectives=grp.collectives,
                collective_bytes_per_step=bucket_bytes,
                launches_before=counts0, launches=launches,
                traced_replay_records=records,
                trace_launches=TRACE_LAUNCHES,
                peak_mem_bytes=torch.cuda.max_memory_allocated())


def _params_close(torch, got, want):
    worst = (0.0, "")
    for n, w in want.items():
        worst = max(worst, (float((got[n].float() - w.detach().float())
                                  .abs().max()),
                            n))
    return worst


def _dist_tp(torch, dist, dev, outdir, rank):
    """dp 1 x tp 2 over gloo, fp32 (TF32 off), ``graphs=False``: three
    steps, a sharded checkpoint after step 2 restored into a fresh trainer
    that replays step 3 bit for bit; then rank 0 runs the one-rank eager
    trainer from the same weights and holds losses and gathered params to
    it."""
    from mxnet_tpu_torch import parallel
    feats, labels = _train_batch(BERT_LARGE["vocab_size"])
    batch = (*feats, *labels)
    head = _dist_head(torch, "cpu")
    mesh = parallel.make_mesh(dp=1, tp=2)
    tr = _dist_trainer(torch, head, mesh, feats, None, False)
    qkv = next(n for n in tr.params if n.endswith("qkv.weight"))
    heads_local = tr.params[qkv].shape[0] // (3 * (BERT_LARGE["units"]
                                                  // BERT_LARGE["num_heads"]))
    _dist_counts(zero=True)
    torch.cuda.reset_peak_memory_stats()
    losses, ms = _timed_steps(torch, tr, batch, 2)
    ck = parallel.CheckpointManager(os.path.join(outdir, "ck"))
    t0 = time.perf_counter()
    ck.save(2, tr)
    ck.wait()
    save_s = time.perf_counter() - t0
    l3, ms3 = _timed_steps(torch, tr, batch, 1)
    losses += l3
    ms += ms3
    launches = _dist_counts()
    after3 = {n: p.detach().clone() for n, p in tr.params.items()}
    peak = torch.cuda.max_memory_allocated()
    fresh = _dist_trainer(torch, head, mesh, feats, None, False)
    t0 = time.perf_counter()
    restored = ck.restore(fresh)
    torch.cuda.synchronize()
    restore_s = time.perf_counter() - t0
    replay = float(fresh.step(*batch))
    bitwise = replay == losses[2] and all(
        torch.equal(fresh.params[n], after3[n]) for n in after3)
    check(restored == 2 and bitwise,
          f"dist_checkpoint: the replayed step 3 ({replay}) is not the "
          f"uninterrupted one ({losses[2]}) bit for bit")
    ck_bytes = _dir_bytes(os.path.join(outdir, "ck", "step_2"))
    del fresh, after3
    t0 = time.perf_counter()
    full = tr.gathered_params()
    gather_s = time.perf_counter() - t0
    # the tp all-reduces of one step: 2 forward + 2 backward a layer, of
    # the (L, B, C) fp32 activations
    L, B = feats[0].shape[1], feats[0].shape[0]
    act = L * B * BERT_LARGE["units"] * 4
    out = dict(losses=losses, ms_per_step=ms, launches=launches,
               heads_local=int(heads_local),
               bh=int(heads_local * B),
               peak_mem_bytes=peak,
               collective_bytes_per_step=4 * BERT_LARGE["num_layers"] * act,
               checkpoint=dict(save_s=save_s, restore_s=restore_s,
                               timings=dict(ck.timings),
                               step_dir_bytes=ck_bytes, replay_loss=replay,
                               bitwise=bitwise),
               gather_s=gather_s)
    del tr
    _free(torch)
    if rank == 0:
        ref = _dist_trainer(torch, head, parallel.Mesh(dev), feats, None,
                            False)
        ref_losses, ref_ms = _timed_steps(torch, ref, batch, DIST_STEPS)
        rel = max(abs(a - b) / abs(b) for a, b in zip(losses, ref_losses))
        worst = _params_close(torch, full, ref.params)
        check(rel <= DIST_LOSS_RTOL,
              f"dist_tp: losses {losses} vs the one-rank trainer's "
              f"{ref_losses}")
        check(worst[0] <= DIST_PARAM_ATOL,
              f"dist_tp: gathered {worst[1]} off by {worst[0]}")
        out.update(losses_one_rank=ref_losses, ms_per_step_one_rank=ref_ms,
                   losses_max_rel_err=rel, params_max_abs_err=worst[0],
                   params_worst=worst[1])
        del ref
    del full
    _free(torch)
    dist.barrier("dist_tp", timeout_s=600)
    return head, out


def _dist_dp_int8(torch, dist, head):
    """dp 2 over gloo, bf16, ``graphs=False``: the uncompressed trainer's
    first step, then three int8-compressed steps (each rank 4 rows of the
    8-row batch)."""
    from mxnet_tpu_torch import parallel
    from mxnet_tpu_torch import runtime_metrics as rm
    feats, labels = _train_batch(BERT_LARGE["vocab_size"])
    batch = (*feats, *labels)
    mesh = parallel.make_mesh(dp=2)
    plain = _dist_trainer(torch, head, mesh, feats, torch.bfloat16, False)
    l_plain, ms_plain = _timed_steps(torch, plain, batch, 1)
    del plain
    _free(torch)
    rm.enable()
    rm.reset()
    comp = _dist_trainer(torch, head, mesh, feats, torch.bfloat16, False,
                         compression="int8")
    _dist_counts(zero=True)
    torch.cuda.reset_peak_memory_stats()
    losses, ms = _timed_steps(torch, comp, batch, DIST_STEPS)
    launches = _dist_counts()
    wire = rm.KV_WIRE_BYTES.value()
    rm.disable()
    check(abs(losses[0] - l_plain[0]) <= DIST_INT8_FIRST_ATOL
          and losses[-1] < losses[0],
          f"dist_dp_int8: losses {losses}, uncompressed first {l_plain}")
    check(comp.wire_bytes_per_step < comp.logical_bytes_per_step
          and wire == DIST_STEPS * comp.wire_bytes_per_step,
          f"dist_dp_int8: wire {wire}, per step "
          f"{comp.wire_bytes_per_step}, logical "
          f"{comp.logical_bytes_per_step}")
    out = dict(losses=losses, loss_uncompressed_first=l_plain[0],
               ms_per_step=ms, ms_uncompressed_step=ms_plain[0],
               wire_bytes_per_step=comp.wire_bytes_per_step,
               logical_bytes_per_step=comp.logical_bytes_per_step,
               kvstore_wire_bytes=wire, launches=launches,
               peak_mem_bytes=torch.cuda.max_memory_allocated())
    del comp
    _free(torch)
    return out


def _dist_ring(torch, dev, rank):
    """sp 2 over gloo, fp32: the causal ring and the causal ring with a
    512 window against the dense masked softmax on one rank (rank 0),
    forward and dQ / dK / dV."""
    from mxnet_tpu_torch import parallel
    from mxnet_tpu_torch.parallel import dist
    from mxnet_tpu_torch.parallel.sharding import all_gather
    c = DIST_RING
    mesh = parallel.make_mesh(dp=1, sp=2)
    gen = torch.Generator().manual_seed(0)
    q, k, v, ct = (torch.randn(c["B"], c["H"], c["L"], c["D"],
                               generator=gen).to(dev) for _ in range(4))
    n = c["L"] // 2
    mine = slice(rank * n, (rank + 1) * n)
    out = {"transport": dist.transport(mesh.group("sp"), mesh.device)}
    for tag, window in (("causal", None), ("window", c["window"])):
        ql, kl, vl = (t[:, :, mine].clone().requires_grad_()
                      for t in (q, k, v))
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        o = parallel.ring_attention(ql, kl, vl, mesh, "sp", causal=True,
                                    window=window)
        torch.cuda.synchronize()
        t1 = time.perf_counter()
        (o * ct[:, :, mine]).sum().backward()
        torch.cuda.synchronize()
        t2 = time.perf_counter()
        group = mesh.group("sp")
        got = [all_gather(t.detach(), group, 2)
               for t in (o, ql.grad, kl.grad, vl.grad)]
        row = dict(fwd_ms=(t1 - t0) * 1e3, bwd_ms=(t2 - t1) * 1e3,
                   peak_mem_bytes=torch.cuda.max_memory_allocated(),
                   hop_bytes_fwd=2 * 4 * ql.numel(),
                   hop_bytes_bwd=4 * 4 * ql.numel() + 2 * 4 * ql.numel())
        if rank == 0:
            qd, kd, vd = (t.clone().requires_grad_() for t in (q, k, v))
            s = torch.einsum("bhqd,bhkd->bhqk", qd, kd) / c["D"] ** 0.5
            i = torch.arange(c["L"], device=dev)
            dead = i[None, :] > i[:, None]
            if window is not None:
                dead = dead | (i[None, :] <= i[:, None] - window)
            p = torch.softmax(s.masked_fill(dead, -1e30), -1)
            ref = torch.einsum("bhqk,bhkd->bhqd", p, vd)
            (ref * ct).sum().backward()
            err = float((got[0] - ref).abs().max())
            gerr = [float((g - w.grad).abs().max() / w.grad.abs().max())
                    for g, w in zip(got[1:], (qd, kd, vd))]
            check(err <= DIST_RING_ATOL and max(gerr) <= DIST_RING_GRAD_TOL,
                  f"dist_ring ({tag}): out err {err}, grad rel errs {gerr}")
            row.update(out_max_abs_err=err, grad_max_rel_err=gerr)
            del qd, kd, vd, s, p, ref
        out[tag] = row
        del got, o, ql, kl, vl
        _free(torch)
    return out


def _dist_ep(torch, dist, dev, rank):
    """dp 1 x ep 2 over gloo, fp32 (TF32 off), ``graphs=False``:
    ``gluon_moe``'s Switch-width layer (a Gluon block, each rank holding
    4 of the 8 experts) at batch 2, three AdamW steps; then rank 0 runs
    the one-rank trainer from the same weights and holds losses and the
    gathered parameters to it."""
    import mxnet_tpu_torch as mx
    from mxnet_tpu_torch import parallel
    cfg = SWITCH
    x, v, y = _switch_batch(cfg["dist_B"], seed=3)
    batch = (x, v, y)

    # one block from seed 0 for both trainers (each holds its own copy)
    mx.random.seed(0)
    with mx.cpu(0):
        net = _switch_layer(mx)
        net.initialize(mx.init.Xavier())

    def loss_fn(outputs, label):
        logits, aux = outputs
        return torch.nn.functional.cross_entropy(
            logits.float(), label.long()) + cfg["aux_weight"] * aux

    def trainer(mesh):
        return parallel.ShardedTrainer(
            net, loss_fn, mesh, optimizer="adamw",
            optimizer_params={"learning_rate": DIST_LR},
            example_inputs=(x, v), n_labels=1, graphs=False)

    tr = trainer(parallel.make_mesh(dp=1, ep=2))
    w1 = next(n for n in tr.params if n.endswith("expert_w1"))
    _dist_counts(zero=True)
    losses, ms = _timed_steps(torch, tr, batch, DIST_STEPS)
    launches = _dist_counts()
    full = tr.gathered_params()
    out = dict(losses=losses, ms_per_step=ms, launches=launches,
               experts_local=int(tr.params[w1].shape[0]),
               w1_spec=[str(a) for a in tr.placements[w1]],
               bound=len(tr._tp_bound))
    del tr
    _free(torch)
    if rank == 0:
        ref = trainer(parallel.Mesh(dev))
        ref_losses, ref_ms = _timed_steps(torch, ref, batch, DIST_STEPS)
        rel = max(abs(a - b) / abs(b) for a, b in zip(losses, ref_losses))
        worst = _params_close(torch, full, ref.params)
        experts = _params_close(torch, full, {
            n: p for n, p in ref.params.items() if "expert_" in n})
        check(rel <= DIST_LOSS_RTOL,
              f"dist_ep: losses {losses} vs the one-rank trainer's "
              f"{ref_losses}")
        check(worst[0] <= DIST_PARAM_ATOL,
              f"dist_ep: gathered {worst[1]} off by {worst[0]}")
        out.update(losses_one_rank=ref_losses, ms_per_step_one_rank=ref_ms,
                   losses_max_rel_err=rel, params_max_abs_err=worst[0],
                   params_worst=worst[1],
                   expert_params_max_abs_err=experts[0])
        del ref
    del full
    _free(torch)
    dist.barrier("dist_ep", timeout_s=600)
    return out


def _gloo_p2p_probe(torch, dist, dev, rank):
    """Whether gloo's send / recv take a CUDA tensor as it is (the port
    stages every gloo hop of a CUDA tensor through host memory whatever
    this finds)."""
    t = torch.full((4,), 7.0, device=dev) if rank == 0 \
        else torch.zeros(4, device=dev)
    try:
        if rank == 0:
            dist.tdist.send(t, dst=1)
        else:
            dist.tdist.recv(t, src=0)
        torch.cuda.synchronize()
        return dict(error=None, received=t.tolist())
    except RuntimeError as e:
        return dict(error=str(e)[:300], received=None)


def dist_worker(job, outdir):
    """One rank of a ``dist`` job (started by the port's launcher):
    ``nccl`` (world 1), ``gloo`` (dist_tp, dist_checkpoint,
    dist_dp_int8, dist_ring and dist_ep on two ranks of the one card) or
    ``probe``.  Loads the kernel libraries the parent built (no
    ``nvcc``) and writes its results to ``<outdir>/<job>-<rank>.json``."""
    import torch
    if not torch.cuda.is_available():
        return 1
    from mxnet_tpu_torch.ops import build
    missing = [n for n in build.SOURCES
               if not os.path.exists(build.library_path(n))]
    check(not missing, f"dist worker: libraries {missing} were not built "
                       f"by the parent")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    torch.set_float32_matmul_precision("highest")
    from mxnet_tpu_torch.parallel import dist
    t0 = time.perf_counter()
    dist.initialize(backend="nccl" if job == "nccl" else "gloo",
                    timeout_s=300)
    rank, dev = dist.rank(), dist.device()
    init_s = time.perf_counter() - t0
    if job == "nccl":
        result = _dist_nccl_worker(torch, dist, dev)
    elif job == "probe":
        result = _gloo_p2p_probe(torch, dist, dev, rank)
    else:
        head, tp = _dist_tp(torch, dist, dev, outdir, rank)
        result = dict(dist_tp=tp, dist_dp_int8=_dist_dp_int8(torch, dist,
                                                             head))
        del head
        _free(torch)
        result["dist_ring"] = _dist_ring(torch, dev, rank)
        result["dist_ep"] = _dist_ep(torch, dist, dev, rank)
    result.update(rank=rank, backend=dist.backend(), device=str(dev),
                  init_s=init_s, seconds=time.perf_counter() - t0)
    _dist_out(outdir, job, rank, result)
    if job != "probe":
        dist.barrier(f"dist {job} done")
    dist.finalize()
    return 0


def _run_dist_job(n, job, outdir, timeout):
    """Launch ``n`` ranks of ``dist_worker(job)`` through the port's
    launcher; returns (exit code, each rank's results or None, seconds)."""
    from mxnet_tpu_torch.tools import launch
    t0 = time.perf_counter()
    rc = launch.launch(n, [sys.executable, os.path.abspath(__file__),
                           "--dist-worker", job, outdir], timeout=timeout)
    results = []
    for r in range(n):
        path = os.path.join(outdir, f"{job}-{r}.json")
        results.append(json.load(open(path)) if os.path.exists(path)
                       else None)
    return rc, results, time.perf_counter() - t0


def phase_dist(torch):
    """The multi-rank phases: ``dist_nccl`` (one NCCL rank), then one
    two-rank gloo job on the one card for ``dist_tp``,
    ``dist_checkpoint``, ``dist_dp_int8`` and ``dist_ring``, and the
    gloo send / recv probe.  Each job's ranks are this script
    (``--dist-worker``) started by ``mxnet_tpu_torch.tools.launch``; a
    rank's failure fails the phase.  Returns the B1-B3 wrapper launches
    by phase (per rank)."""
    root = tempfile.mkdtemp(prefix="mxnet-dist-")
    parent_reserved = torch.cuda.memory_reserved()
    try:
        rc, (nccl,), secs = _run_dist_job(1, "nccl", root,
                                          DIST_JOB_TIMEOUT_S)
        check(rc == 0 and nccl, f"dist_nccl: the job exited {rc}")
        emit("dist_nccl", model="bert_24_1024_16", dtype="bfloat16",
             world=1, backend=nccl["backend"], steps=DIST_STEPS,
             job_seconds=secs, parent_reserved_bytes=parent_reserved,
             **{k: v for k, v in nccl.items()
                                  if k not in ("backend", "launches_before")})
        per_step = BERT_LARGE["num_layers"]
        check(all(v == 2 * per_step for v in nccl["launches"].values()),
              f"dist_nccl: B1-B3 wrapper launches {nccl['launches']}, want "
              f"{per_step} for each trainer's first (eager) step")
        rc, ranks, secs = _run_dist_job(2, "gloo", root, DIST_JOB_TIMEOUT_S)
        check(rc == 0 and all(ranks), f"dist (gloo): the job exited {rc}")
        for r in ranks:
            for key in ("dist_tp", "dist_dp_int8"):
                check(all(v == DIST_STEPS * per_step
                          for v in r[key]["launches"].values()),
                      f"{key}: rank {r['rank']}'s B1-B3 launches "
                      f"{r[key]['launches']}, want {per_step} a step")
            check(r["dist_tp"]["bh"] == 8 * BERT_LARGE["num_heads"] // 2,
                  f"dist_tp: B1-B3 ran at BH {r['dist_tp']['bh']}")
        label = ("two ranks on one card through host memory, not a "
                 "multi-GPU figure")
        tp = [r["dist_tp"] for r in ranks]
        emit("dist_tp", model="bert_24_1024_16", dtype="float32",
             mesh="dp1 x tp2", backend="gloo", steps=DIST_STEPS,
             lr=DIST_LR, job_seconds=secs, timing=label,
             ranks=[{k: v for k, v in t.items() if k != "checkpoint"}
                    for t in tp])
        emit("dist_checkpoint", model="bert_24_1024_16", dtype="float32",
             mesh="dp1 x tp2", saved_after_step=2, replayed_step=3,
             ranks=[t["checkpoint"] for t in tp])
        emit("dist_dp_int8", model="bert_24_1024_16", dtype="bfloat16",
             mesh="dp2", backend="gloo", compression="int8",
             steps=DIST_STEPS, rows_per_rank=4, timing=label,
             ranks=[r["dist_dp_int8"] for r in ranks])
        rc_p, probe, _ = _run_dist_job(2, "probe", root,
                                       DIST_PROBE_TIMEOUT_S)
        emit("dist_ring", dtype="float32", mesh="sp2", backend="gloo",
             causal=True, **{k: DIST_RING[k] for k in ("B", "H", "L", "D")},
             window=DIST_RING["window"], timing=label,
             transport=ranks[0]["dist_ring"]["transport"],
             gloo_cuda_p2p_probe=dict(exit_code=rc_p, ranks=probe),
             ranks=[r["dist_ring"] for r in ranks])
        ep = [r["dist_ep"] for r in ranks]
        emit("dist_ep", layer="gluon_moe's Switch-Base-8-width layer",
             dtype="float32", mesh="dp1 x ep2", backend="gloo",
             steps=DIST_STEPS, lr=DIST_LR, batch=SWITCH["dist_B"],
             L=SWITCH["L"], experts=SWITCH["experts"], timing=label,
             loss_rtol=DIST_LOSS_RTOL, param_atol=DIST_PARAM_ATOL,
             ranks=ep)
        for e in ep:
            check(e["experts_local"] == SWITCH["experts"] // 2
                  and e["w1_spec"][0] == "ep" and e["bound"] == 1,
                  f"dist_ep: rank layout {e}")
            check(all(n == DIST_STEPS for n in e["launches"].values()),
                  f"dist_ep: B1-B3 wrapper launches {e['launches']}, want "
                  f"one a step")
        return {"dist_nccl": nccl["launches"],
                "dist_nccl_traced": nccl["traced_replay_records"]["grouped"],
                "dist_tp": tp[0]["launches"],
                "dist_dp_int8": ranks[0]["dist_dp_int8"]["launches"],
                "dist_ep": ep[0]["launches"]}
    finally:
        shutil.rmtree(root, ignore_errors=True)


# ------------------------------------------------------------------- gluon
# The Gluon training path of mxnet_tpu_torch (NDArray, autograd,
# gluon.{nn,loss,Trainer}, the kvstore) through the entry points a user
# calls.  LeNet: examples/mnist_gluon.py at its published widths; the
# encoder layer: one BERT-large layer (units 1024, 16 heads, FFN 4096) as
# a user HybridBlock around F.flash_selfatt (B1 forward, B2 / B3 in its
# backward), L 512, batch 8, fp32.
GLUON_LENET = dict(batch=64, steps=20, lr=1e-3, host_steps=3)
# LeNet losses, card vs host from the same weights (TF32 off): step 1
# sums the same fp32 products in cuDNN's order and the host's (1e-5
# relative); steps 2-3 follow Adam's normalised update, which turns a
# near-zero gradient's rounding into a step of up to lr on that weight
# (1e-3 relative)
GLUON_LENET_RTOL = (1e-5, 1e-3, 1e-3)
GLUON_FLASH = dict(units=1024, heads=16, ffn=4096, L=512, B=8, steps=3,
                   lr=1e-4, valid=(377, 280, 179, 450, 112, 92, 230, 64))
# the encoder layer on the card (B1-B3 3xTF32, cuBLAS GEMMs with TF32
# off) vs the same layer on the host (the plain attention): step 1's
# loss to 1e-4 relative and the qkv weight's gradient to 1e-3 of its
# max|grad| (FLASH_TOL's fp32 bounds: the attention's sums run over up
# to 512 keys and 4096 rows in another order); steps 2-3 after Adam,
# whose normalised update amplifies a near-zero gradient's rounding
# (1e-3 relative)
GLUON_FLASH_LOSS_RTOL = (1e-4, 1e-3, 1e-3)
GLUON_FLASH_GRAD_TOL = 1e-3
# two-rank dist_sync SGD vs the one-rank full batch: the summed half
# batches differ from the full batch's sums in order only
GLUON_DIST = dict(steps=3, lr=1e-3)
GLUON_DIST_LOSS_RTOL = 1e-4
GLUON_DIST_PARAM_TOL = 1e-5            # of the parameter's max|w|
GLUON_DIST_TIMEOUT_S = 300


def _lenet(mx):
    nn = mx.gluon.nn
    net = nn.HybridSequential()
    with net.name_scope():
        net.add(nn.Conv2D(channels=20, kernel_size=5, activation="relu"),
                nn.MaxPool2D(pool_size=2, strides=2),
                nn.Conv2D(channels=50, kernel_size=5, activation="relu"),
                nn.MaxPool2D(pool_size=2, strides=2),
                nn.Dense(500, activation="relu"),
                nn.Dense(10))
    return net


def _gluon_stepper(mx, trainer, batch, net=None, block=None, split=None,
                   lazy=None, read_early=False):
    """One record / backward / ``Trainer.step`` over ``batch`` = (inputs...,
    label): ``block(*batch)`` (the loss inside a block) or
    ``SoftmaxCrossEntropyLoss()(net(*inputs), label)``; returns the loss.
    ``split`` gets each step's host ms of the recorded call, the backward
    and the step (no synchronise), ``lazy`` whether the loss was lazy
    after ``record()``; ``read_early`` reads the loss between the
    backward and the step."""
    loss_fn = mx.gluon.loss.SoftmaxCrossEntropyLoss()
    *inputs, label = batch

    def step():
        t0 = time.perf_counter()
        with mx.autograd.record():
            loss = block(*batch) if block is not None \
                else loss_fn(net(*inputs), label)
        t1 = time.perf_counter()
        loss.backward()
        t2 = time.perf_counter()
        if lazy is not None:
            lazy.append(loss._lazy is not None)
        if read_early:
            loss.asnumpy()
        t3 = time.perf_counter()
        trainer.step(label.shape[0])
        if split is not None:
            split.append(((t1 - t0) * 1e3, (t2 - t1) * 1e3,
                          (time.perf_counter() - t3) * 1e3))
        return loss
    return step


def _gluon_loop(step, steps, sync=None, on_step=None):
    """``steps`` calls of ``step``, each closed by ``sync``; returns
    (losses, ms a step).  ``on_step(i)`` runs after each step."""
    losses, ms = [], []
    for i in range(steps):
        t0 = time.perf_counter()
        loss = step()
        if sync is not None:
            sync()
        ms.append((time.perf_counter() - t0) * 1e3)
        losses.append(float(loss.mean().asscalar()))
        if on_step is not None:
            on_step(i)
    return losses, ms


def _gluon_run(mx, net, batch, steps, opt, opt_params, on_step=None,
               sync=None, fused=True):
    """``steps`` record / backward / ``Trainer.step`` iterations of
    ``net`` on ``batch`` = (inputs..., label) on one context; returns
    (losses, ms a step).  ``on_step(step)`` runs after each step.
    ``fused=False`` turns the optimizer's fused form off: every step
    takes the per-parameter ``Updater`` path."""
    trainer = mx.gluon.Trainer(net.collect_params(), opt, opt_params)
    if not fused:
        trainer.optimizer.fused = False
    return _gluon_loop(_gluon_stepper(mx, trainer, batch, net=net), steps,
                       sync=sync, on_step=on_step)


def _lenet_weights(mx, path, x):
    """LeNet's weights from seed 0 (drawn on the host), saved."""
    mx.random.seed(0)
    with mx.cpu(0):
        host = _lenet(mx)
        host.initialize(mx.init.Xavier())
        host(mx.nd.array(x[:1]))
        host.save_parameters(path)


def phase_gluon_lenet(torch):
    """``gluon_lenet``: LeNet (published widths) trained by Adam through
    ``autograd.record`` / ``backward`` / ``gluon.Trainer.step`` on the
    card, batch 64 of 1x28x28, once through the fused update and once
    through the per-parameter ``Updater`` (Adam's fused form off); the
    first steps of each against the same run on the host from the same
    weights."""
    import mxnet_tpu_torch as mx
    cfg = GLUON_LENET
    rs = np.random.RandomState(0)
    x = rs.rand(cfg["batch"], 1, 28, 28).astype(np.float32)
    y = rs.randint(0, 10, cfg["batch"]).astype(np.float32)
    tmp = tempfile.mkdtemp(prefix="mxnet-gluon-")
    try:
        path = os.path.join(tmp, "lenet.npz")
        _lenet_weights(mx, path, x)
        with mx.cpu(0):
            host = _lenet(mx)
            host.load_parameters(path)
            host_losses, host_ms = _gluon_run(
                mx, host, (mx.nd.array(x), mx.nd.array(y)),
                cfg["host_steps"], "adam", {"learning_rate": cfg["lr"]})
        card = {}
        with mx.gpu(0):
            for fused in (True, False):
                net = _lenet(mx)
                net.load_parameters(path)
                card[fused] = _gluon_run(
                    mx, net, (mx.nd.array(x), mx.nd.array(y)), cfg["steps"],
                    "adam", {"learning_rate": cfg["lr"]},
                    sync=torch.cuda.synchronize, fused=fused)
                device = str(net[0].weight.data().data_torch.device)
                del net
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    (losses, ms), (pp_losses, pp_ms) = card[True], card[False]
    rel = [abs(a - b) / abs(b) for a, b in zip(losses, host_losses)]
    pp_rel = [abs(a - b) / abs(b) for a, b in zip(pp_losses, host_losses)]
    emit("gluon_lenet", model="lenet (examples/mnist_gluon.py)",
         batch=cfg["batch"], steps=cfg["steps"], optimizer="adam",
         lr=cfg["lr"], dtype="float32", device=device, losses=losses,
         host_losses=host_losses, loss_rel_err=rel,
         loss_rtol=GLUON_LENET_RTOL,
         ms_per_step=float(np.median(ms[3:])), first_step_ms=ms[0],
         host_ms_per_step=float(np.median(host_ms)),
         per_param=dict(losses=pp_losses, loss_rel_err=pp_rel,
                        ms_per_step=float(np.median(pp_ms[3:])),
                        first_step_ms=pp_ms[0],
                        rel_err_vs_fused=max(
                            abs(a - b) / abs(b)
                            for a, b in zip(pp_losses, losses))))
    check(device.startswith("cuda"), f"gluon_lenet: trained on {device}")
    for name, ls, r in (("fused", losses, rel),
                        ("per-parameter", pp_losses, pp_rel)):
        check(all(np.isfinite(ls)), f"gluon_lenet {name}: losses {ls}")
        check(ls[-1] < ls[0], f"gluon_lenet {name}: losses did not fall "
                              f"({ls[0]} -> {ls[-1]})")
        check(all(e <= t for e, t in zip(r, GLUON_LENET_RTOL)),
              f"gluon_lenet {name}: card vs host losses {r}, want "
              f"{GLUON_LENET_RTOL}")


def _encoder_layer(mx, units, heads, ffn):
    """One BERT-large-width encoder layer as a user HybridBlock (as
    ``tests/test_gluon.py::test_custom_hybrid_block`` writes one):
    qkv -> ``F.flash_selfatt`` -> proj, residual + LayerNorm, FFN with
    GELU, residual + LayerNorm, and a two-way head on position 0.  Its
    ``hybrid_forward`` composes over Symbols as well (``symbolic``)."""
    nn = mx.gluon.nn

    class EncoderLayer(mx.gluon.HybridBlock):
        def __init__(self, **kw):
            super().__init__(**kw)
            with self.name_scope():
                self.qkv = nn.Dense(3 * units, flatten=False,
                                    in_units=units)
                self.proj = nn.Dense(units, flatten=False, in_units=units)
                self.ln1 = nn.LayerNorm(in_channels=units)
                self.ffn1 = nn.Dense(ffn, flatten=False, in_units=units)
                self.gelu = nn.GELU()
                self.ffn2 = nn.Dense(units, flatten=False, in_units=ffn)
                self.ln2 = nn.LayerNorm(in_channels=units)
                self.head = nn.Dense(2, in_units=units)

        def hybrid_forward(self, F, x, valid_length):
            att = F.flash_selfatt(self.qkv(x), valid_length, heads=heads)
            h = self.ln1(x + self.proj(att))
            h = self.ln2(h + self.ffn2(self.gelu(self.ffn1(h))))
            # position 0 (h[0] on arrays; written so that the layer also
            # composes over Symbol inputs, where [0] picks an output)
            return self.head(F.squeeze(F.slice_axis(h, axis=0, begin=0,
                                                    end=1), axis=0))

    return EncoderLayer()


def _encoder_batch(cfg, seed=1):
    rs = np.random.RandomState(seed)
    x = (rs.randn(cfg["L"], cfg["B"], cfg["units"]) * 0.5).astype(
        np.float32)
    valid = np.array(cfg["valid"][:cfg["B"]], np.float32)
    y = rs.randint(0, 2, cfg["B"]).astype(np.float32)
    return x, valid, y


def _encoder_weights(mx, cfg, path):
    """The layer's weights from seed 0 (drawn on the host), saved."""
    mx.random.seed(0)
    with mx.cpu(0):
        net = _encoder_layer(mx, cfg["units"], cfg["heads"], cfg["ffn"])
        net.initialize(mx.init.Xavier())
        net.save_parameters(path)


def _b4_through_nd(torch, mx):
    """One ``nd.ragged_paged_attention_op`` call at GPT-2-small decode
    geometry (``phase_kernels``' B4 batch) on the card and on the host:
    (max |card - host|, B4 launches in the card's call)."""
    from mxnet_tpu_torch.ops import paged_attention as pa
    g = torch.Generator(device="cpu").manual_seed(0)
    B, H, D, P = MAX_BATCH, GPT2_SMALL["num_heads"], 64, 64
    N = B * P + 1
    host = dict(
        q=torch.randn(B, H, D, generator=g).numpy(),
        k=torch.randn(N, PAGE_SIZE, H, D, generator=g).numpy(),
        v=torch.randn(N, PAGE_SIZE, H, D, generator=g).numpy(),
        bt=(torch.randperm(N - 1, generator=g)[:B * P] + 1).reshape(
            B, P).numpy().astype(np.float32),
        ctx=np.array([0, 1, 16, 17, 300, 511, 777, 1024], np.float32))
    outs, launches = {}, None
    for where in (mx.gpu(0), mx.cpu(0)):
        before = pa.ragged_paged_attention.launches
        with where:
            arrs = [mx.nd.array(host[k]) for k in ("q", "k", "v", "bt",
                                                   "ctx")]
            outs[where.device_type] = mx.nd.ragged_paged_attention_op(
                *arrs).asnumpy()
        if launches is None:
            launches = pa.ragged_paged_attention.launches - before
    return float(np.abs(outs["gpu"] - outs["cpu"]).max()), launches


def phase_gluon_flash(torch):
    """``gluon_flash``: the encoder layer trained by Adam through
    ``gluon.Trainer`` on the card (B1 once a forward, B2 and B3 once each
    a backward), against the same layer on the host; then B4 through
    ``nd.ragged_paged_attention_op``.  Returns the wrapper launches."""
    import mxnet_tpu_torch as mx
    cfg = GLUON_FLASH
    steps = cfg["steps"]
    x, valid, y = _encoder_batch(cfg)
    tmp = tempfile.mkdtemp(prefix="mxnet-gluon-")
    runs = {}
    try:
        path = os.path.join(tmp, "encoder.npz")
        _encoder_weights(mx, cfg, path)
        for where in (mx.gpu(0), mx.cpu(0)):
            on_card = where.device_type == "gpu"
            with where:
                net = _encoder_layer(mx, cfg["units"], cfg["heads"],
                                     cfg["ffn"])
                net.load_parameters(path)
                grads = []

                def first_grad(step, net=net, grads=grads):
                    if step == 0:
                        grads.append(net.qkv.weight.grad().asnumpy())

                if on_card:
                    _dist_counts(zero=True)
                losses, ms = _gluon_run(
                    mx, net, (mx.nd.array(x), mx.nd.array(valid),
                              mx.nd.array(y)), steps, "adam",
                    {"learning_rate": cfg["lr"]}, on_step=first_grad,
                    sync=torch.cuda.synchronize if on_card else None)
                if on_card:
                    launches = _dist_counts()
                runs[where.device_type] = dict(losses=losses, ms=ms,
                                               grad=grads[0])
                del net
        _free(torch)
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    card, host = runs["gpu"], runs["cpu"]
    rel = [abs(a - b) / abs(b) for a, b in zip(card["losses"],
                                               host["losses"])]
    gerr = float(np.abs(card["grad"] - host["grad"]).max()
                 / np.abs(host["grad"]).max())
    b4_err, b4_launches = _b4_through_nd(torch, mx)
    emit("gluon_flash", layer="bert_24_1024_16 encoder layer (user "
         "HybridBlock, F.flash_selfatt)", dtype="float32",
         **{k: cfg[k] for k in ("units", "heads", "ffn", "L", "B")},
         valid_length=list(cfg["valid"]), optimizer="adam", lr=cfg["lr"],
         losses=card["losses"], host_losses=host["losses"],
         loss_rel_err=rel, loss_rtol=GLUON_FLASH_LOSS_RTOL,
         qkv_grad_rel_err=gerr, qkv_grad_tol=GLUON_FLASH_GRAD_TOL,
         launches=launches, ms_per_step=float(np.median(card["ms"][1:])),
         first_step_ms=card["ms"][0],
         host_ms_per_step=float(np.median(host["ms"])),
         b4_through_nd=dict(max_abs_err=b4_err, launches=b4_launches,
                            geometry="gpt2-small decode, kernels' B4 "
                                     "batch"))
    check(all(np.isfinite(card["losses"])),
          f"gluon_flash: losses {card['losses']}")
    check(all(r <= t for r, t in zip(rel, GLUON_FLASH_LOSS_RTOL)),
          f"gluon_flash: card vs host losses {rel}")
    check(gerr <= GLUON_FLASH_GRAD_TOL,
          f"gluon_flash: qkv weight gradient {gerr} of max|grad|")
    check(launches == {"flash_attention_fwd": steps,
                       "flash_attention_bwd_dq": steps,
                       "flash_attention_bwd_dkv": steps},
          f"gluon_flash: B1-B3 launches {launches}, want {steps} each")
    check(b4_launches == 1 and b4_err <= TOL["float32"]["atol"],
          f"gluon_flash: B4 through nd: {b4_launches} launches, error "
          f"{b4_err}")
    return dict(launches, ragged_paged_attention=b4_launches)


def _param_digest(net):
    import hashlib
    h = hashlib.sha256()
    for p in net.collect_params().values():
        h.update(p.data().asnumpy().tobytes())
    return h.hexdigest()


def _gluon_dist_worker(torch, outdir, rank):
    """One rank of ``gluon_dist``: the reference's ``dist_sync`` sequence
    on CUDA values; the encoder layer by SGD over ``kvstore="dist_sync"``
    on this rank's 4 rows, rank 1 starting from other weights; one
    int8-compressed push of its gradients."""
    import mxnet_tpu_torch as mx
    from mxnet_tpu_torch import runtime_metrics as rm
    cfg = GLUON_FLASH
    with mx.gpu(0):
        kv = mx.kv.create("dist_sync")
        kv.init("w", mx.nd.array(np.full((2,), 10.0 * (kv.rank + 1),
                                         np.float32)))
        w0 = mx.nd.zeros((2,))
        kv.pull("w", out=w0)
        kv.init("3", mx.nd.zeros((2, 2)))
        kv.push("3", mx.nd.array(np.full((2, 2), kv.rank + 1.0,
                                         np.float32)))
        out = mx.nd.zeros((2, 2))
        kv.pull("3", out=out)
        seq = dict(init_wins=w0.asnumpy().tolist(),
                   pushed_sum=out.asnumpy().tolist(),
                   device=str(out.data_torch.device))
        net = _encoder_layer(mx, cfg["units"], cfg["heads"], cfg["ffn"])
        net.load_parameters(os.path.join(outdir, "encoder.npz"))
        if rank == 1:
            for p in net.collect_params().values():
                p.set_data(p.data() * 1.5)
        x, valid, y = _encoder_batch(cfg)
        rows = slice(4 * rank, 4 * rank + 4)
        data, lens, label = (mx.nd.array(x[:, rows]),
                             mx.nd.array(valid[rows]),
                             mx.nd.array(y[rows]))
        _dist_counts(zero=True)
        trainer = mx.gluon.Trainer(net.collect_params(), "sgd",
                                   {"learning_rate": GLUON_DIST["lr"]},
                                   kvstore="dist_sync")
        digests, sums, ms = [_param_digest(net)], [], []
        loss_fn = mx.gluon.loss.SoftmaxCrossEntropyLoss()
        for step in range(GLUON_DIST["steps"]):
            t0 = time.perf_counter()
            with mx.autograd.record():
                loss = loss_fn(net(data, lens), label)
            loss.backward()
            trainer.step(cfg["B"])
            torch.cuda.synchronize()
            ms.append((time.perf_counter() - t0) * 1e3)
            sums.append(float(loss.sum().asscalar()))
            digests.append(_param_digest(net))
            if rank == 0:
                mx.nd.save(os.path.join(outdir, f"step{step}.npz"),
                           {k: p.data() for k, p in
                            net._collect_params_with_prefix().items()})
        launches = _dist_counts()
        grads = [p.grad() for p in net.collect_params().values()]
        keys = [f"g{i}" for i in range(len(grads))]
        kv8 = mx.kv.create("dist_sync")
        kv8.set_gradient_compression({"type": "int8"})
        kv8.init(keys, [mx.nd.zeros(g.shape) for g in grads])
        rm.enable()
        rm.reset()
        t0 = time.perf_counter()
        kv8.push(keys, grads)
        torch.cuda.synchronize()
        int8 = dict(push_bytes=rm.KV_PUSH_BYTES.value(),
                    wire_bytes=rm.KV_WIRE_BYTES.value(),
                    ms=(time.perf_counter() - t0) * 1e3)
        rm.disable()
        rm.reset()
    return dict(rank=rank, kvstore=trainer._kvstore.type, sequence=seq,
                digests=digests, loss_sums=sums, ms=ms, launches=launches,
                grad_bytes=sum(g.size * 4 for g in grads), int8=int8)


def gluon_worker(outdir):
    """One rank of ``gluon_dist`` (started by the port's launcher): loads
    the kernel libraries the parent built (no ``nvcc``) and writes its
    results to ``<outdir>/gluon-<rank>.json``."""
    import torch
    if not torch.cuda.is_available():
        return 1
    from mxnet_tpu_torch.ops import build
    missing = [n for n in build.SOURCES
               if not os.path.exists(build.library_path(n))]
    check(not missing, f"gluon worker: libraries {missing} were not built "
                       f"by the parent")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    torch.set_float32_matmul_precision("highest")
    from mxnet_tpu_torch.parallel import dist
    t0 = time.perf_counter()
    dist.initialize(backend="gloo", timeout_s=300)
    rank = dist.rank()
    init_s = time.perf_counter() - t0
    result = _gluon_dist_worker(torch, outdir, rank)
    result.update(backend=dist.backend(), device=str(dist.device()),
                  init_s=init_s, seconds=time.perf_counter() - t0)
    _dist_out(outdir, "gluon", rank, result)
    dist.barrier("gluon done")
    dist.finalize()
    return 0


def _dist_param_err(mx, net, path):
    """max over parameters of max|saved - live| / max|live|."""
    saved = mx.nd.load(path)
    worst = 0.0
    for k, p in net._collect_params_with_prefix().items():
        w = p.data().asnumpy()
        worst = max(worst, float(np.abs(saved[k].asnumpy() - w).max()
                                 / np.abs(w).max()))
    return worst


def phase_gluon_dist(torch):
    """``gluon_dist``: two gloo ranks on the one card (this script with
    ``--gluon-worker``), ``gluon.Trainer(..., "sgd",
    kvstore="dist_sync")`` on the encoder layer, the batch of 8 split
    4 + 4: ranks equal bit for bit before the first step and after each,
    and equal to the one-rank full-batch run; the reference's
    ``dist_sync`` sequence on CUDA values; int8 compression's wire bytes
    under the push bytes.  Returns rank 0's B1-B3 wrapper launches."""
    import mxnet_tpu_torch as mx
    from mxnet_tpu_torch.tools import launch
    cfg = GLUON_FLASH
    steps = GLUON_DIST["steps"]
    root = tempfile.mkdtemp(prefix="mxnet-gluon-dist-")
    try:
        path = os.path.join(root, "encoder.npz")
        _encoder_weights(mx, cfg, path)
        t0 = time.perf_counter()
        rc = launch.launch(2, [sys.executable, os.path.abspath(__file__),
                               "--gluon-worker", root],
                           timeout=GLUON_DIST_TIMEOUT_S)
        job_s = time.perf_counter() - t0
        ranks = []
        for r in range(2):
            p = os.path.join(root, f"gluon-{r}.json")
            ranks.append(json.load(open(p)) if os.path.exists(p) else None)
        check(rc == 0 and all(ranks), f"gluon_dist: the job exited {rc}")
        # one rank, the whole batch, from rank 0's weights
        x, valid, y = _encoder_batch(cfg)
        errs = []
        with mx.gpu(0):
            net = _encoder_layer(mx, cfg["units"], cfg["heads"], cfg["ffn"])
            net.load_parameters(path)
            losses, ms = _gluon_run(
                mx, net, (mx.nd.array(x), mx.nd.array(valid),
                          mx.nd.array(y)), steps, "sgd",
                {"learning_rate": GLUON_DIST["lr"]},
                on_step=lambda s: errs.append(_dist_param_err(
                    mx, net, os.path.join(root, f"step{s}.npz"))),
                sync=torch.cuda.synchronize)
            del net
        _free(torch)
    finally:
        shutil.rmtree(root, ignore_errors=True)
    two = [(a + b) / cfg["B"] for a, b in zip(ranks[0]["loss_sums"],
                                              ranks[1]["loss_sums"])]
    rel = [abs(a - b) / abs(b) for a, b in zip(two, losses)]
    emit("gluon_dist", layer="bert_24_1024_16 encoder layer",
         dtype="float32", world=2, backend=ranks[0]["backend"],
         kvstore=ranks[0]["kvstore"], optimizer="sgd",
         lr=GLUON_DIST["lr"], rows_per_rank=cfg["B"] // 2, steps=steps,
         timing="two ranks on one card through host memory, not a "
                "multi-GPU figure",
         job_seconds=job_s, losses_two_ranks=two, losses_one_rank=losses,
         loss_rel_err=rel, param_rel_err=errs,
         bitwise_equal=[a == b for a, b in zip(ranks[0]["digests"],
                                               ranks[1]["digests"])],
         one_rank_ms_per_step=float(np.median(ms[1:])),
         ranks=[{k: r[k] for k in ("rank", "device", "init_s", "seconds",
                                   "ms", "launches", "grad_bytes", "int8",
                                   "sequence")} for r in ranks])
    for r in ranks:
        check(r["kvstore"] == "dist_sync", f"gluon_dist: {r['kvstore']}")
        check(r["sequence"]["init_wins"] == [10.0, 10.0]
              and r["sequence"]["pushed_sum"] == [[3.0, 3.0], [3.0, 3.0]]
              and r["sequence"]["device"].startswith("cuda"),
              f"gluon_dist: dist_sync sequence {r['sequence']}")
        check(r["int8"]["wire_bytes"] < r["int8"]["push_bytes"],
              f"gluon_dist: int8 wire bytes {r['int8']}")
        check(r["launches"] == {"flash_attention_fwd": steps,
                                "flash_attention_bwd_dq": steps,
                                "flash_attention_bwd_dkv": steps},
              f"gluon_dist: rank {r['rank']}'s B1-B3 {r['launches']}")
    check(ranks[0]["digests"] == ranks[1]["digests"],
          "gluon_dist: the ranks' parameters differ")
    check(all(e <= GLUON_DIST_PARAM_TOL for e in errs),
          f"gluon_dist: parameters vs the one-rank run {errs}")
    check(all(e <= GLUON_DIST_LOSS_RTOL for e in rel),
          f"gluon_dist: losses vs the one-rank run {rel}")
    return ranks[0]["launches"]


# ------------------------------------------------------------ gluon_hybrid
# hybridize's CachedOp tier and Trainer's fused tiers, at gluon_lenet's and
# gluon_flash's widths, weights and data: LeNet hybridized with its loss
# outside (forward and backward graphs, then the ``_fused_update``
# graph), and the encoder layer with SoftmaxCrossEntropyLoss inside one
# hybridized block (forward graph, then the deferred backward + update
# graph, B2 and B3 inside it), each against the same eager run on the
# card from the same weights; the layer's inference replay, bucketed
# lengths, a bounded cache, Dropout and BatchNorm.
GLUON_HYBRID = dict(lenet_steps=20, encoder_steps=10, traced_steps=3,
                    buckets=(128, 256, 512),
                    lengths=(100, 128, 200, 300, 512),
                    cache_size=2, cache_batches=(1, 2, 4, 8),
                    micro_batches=8, clip_fractions=(2.0, 0.5, 0.1))
# the encoder layer's runs: eager; hybridized with the lazy forward (the
# default: one full-step graph a step from the third step on); with
# MXNET_DEFERRED_HYBRID_FWD=0 ("two_graphs": the forward graph, then the
# backward + update graph); with the loss read before each step (the lazy
# forward materialized, then the backward + update graph)
ENCODER_MODES = ("eager", "hybrid", "two_graphs", "read_early")
# the lazy forward against the two-graph path from the same weights: the
# same kernels on the same inputs (losses relative, parameters of their
# max|w|)
GLUON_HYBRID_DEFERRED_TOL = 1e-5
# trainer.grad_norm (float64 on the card) against the host's float64 norm
# of the same .grad buffers; clip_global_norm's graph against the same
# torch ops run eagerly on the card (of each array's max)
GLUON_HYBRID_GRAD_NORM_RTOL = 1e-6
GLUON_HYBRID_CLIP_TOL = 1e-6
# the first hybridized loss: the eager call's kernels on the same inputs
# (1e-6 relative; whether it is bitwise is reported)
GLUON_HYBRID_FIRST_RTOL = 1e-6
# later losses and the last parameters: a replay runs the eager run's
# kernels on the same inputs, but cuBLAS and cuDNN pick their algorithm
# per call site, stream and workspace, so a captured call may sum in
# another order, and Adam's normalised step turns such rounding in a
# near-zero gradient into up to lr on that weight: the CPU parity bounds
# (tests/test_torch_fused_trainer.py)
GLUON_HYBRID_LOSS_RTOL = 1e-4
GLUON_HYBRID_PARAM_TOL = (1e-3, 1e-4)          # rtol, atol
# inference replays vs the eager forward of the same (padded) input: the
# same kernels (1e-6 of max|out|); bucketed outputs vs the eager forward
# of the unpadded input: B1 and the GEMMs then run other shapes and sum
# in another order (1e-4 of max|out|, GLUON_FLASH_LOSS_RTOL's first-step
# bound)
GLUON_HYBRID_BUCKET_TOL = (1e-6, 1e-4)
# BatchNorm's running statistics after hybridized training calls vs the
# eager ones (the same kernels)
GLUON_HYBRID_BN_TOL = 1e-6
# device memory after two evictions over what the evicted and the new
# programs' pools predict: the allocator's rounding of the small tensors
# a call leaves (4 MiB)
GLUON_HYBRID_CACHE_SLACK = 4 << 20


def _hybrid_trace(torch, run, where):
    """``_trace_steps`` over ``GLUON_HYBRID['traced_steps']`` steps of a
    ``_hybrid_lenet`` / ``_hybrid_encoder`` run, after a warm-up step,
    with B1-B3's records per step."""
    return _trace_steps(torch, run["step"], GLUON_HYBRID["traced_steps"],
                        float(np.median(run["ms"][2:])), warm=run["step"],
                        where=f"gluon_hybrid {where}", names=FLASH_NAMES)


def _gluon_param_err(a_net, b_net):
    """Largest |a - b| over max(rtol·|b|, atol) across the parameters
    (<= 1 is within GLUON_HYBRID_PARAM_TOL)."""
    rtol, atol = GLUON_HYBRID_PARAM_TOL
    worst = 0.0
    for pa, pb in zip(a_net.collect_params().values(),
                      b_net.collect_params().values()):
        a, b = pa.data().asnumpy(), pb.data().asnumpy()
        worst = max(worst, float((np.abs(a - b)
                                  / (atol + rtol * np.abs(b))).max()))
    return worst


def _hybrid_lenet(torch, mx, path, x, y):
    from mxnet_tpu_torch.gluon.block import nb_cached_programs
    cfg = GLUON_LENET
    steps = GLUON_HYBRID["lenet_steps"]
    runs = {}
    for mode in ("eager", "hybrid"):
        net = _lenet(mx)
        net.load_parameters(path)
        if mode == "hybrid":
            net.hybridize()
        trainer = mx.gluon.Trainer(net.collect_params(), "adam",
                                   {"learning_rate": cfg["lr"]})
        step = _gluon_stepper(mx, trainer, (mx.nd.array(x), mx.nd.array(y)),
                              net=net)
        programs = []
        losses, ms = _gluon_loop(
            step, steps, sync=torch.cuda.synchronize,
            on_step=lambda _i: programs.append(nb_cached_programs()))
        runs[mode] = dict(net=net, trainer=trainer, step=step,
                          losses=losses, ms=ms, programs=programs)
    return runs


@contextlib.contextmanager
def _deferred_forward(on):
    """``MXNET_DEFERRED_HYBRID_FWD`` for the block: ``"1"`` (the default)
    or ``"0"`` (the recorded calls run when made: two graphs a step)."""
    old = os.environ.get("MXNET_DEFERRED_HYBRID_FWD")
    os.environ["MXNET_DEFERRED_HYBRID_FWD"] = "1" if on else "0"
    try:
        yield
    finally:
        if old is None:
            os.environ.pop("MXNET_DEFERRED_HYBRID_FWD")
        else:
            os.environ["MXNET_DEFERRED_HYBRID_FWD"] = old


def _graph_replays(block, trainer):
    """Every CUDA graph replay of a hybridized block and its Trainer: the
    CachedOp's forward and backward graphs, the ``_fused_update`` graphs
    and the instances' fused entries (backward + update, full step)."""
    return (block._cached_op.stats()["replays"]
            + trainer.fused_stats()["replays"]
            + sum(e.replays for e in trainer._fused_step_progs.values()))


def _hybrid_encoder(torch, mx, path, batch):
    """The encoder layer with its loss: eager, hybridized with the lazy
    forward (one full-step graph a step), hybridized with
    ``MXNET_DEFERRED_HYBRID_FWD=0`` (the forward graph, then the backward
    + update graph) and hybridized with the loss read before each step
    (the forward materialized)."""
    cfg = GLUON_FLASH
    steps = GLUON_HYBRID["encoder_steps"]
    runs = {}
    for mode in ENCODER_MODES:
        net = _encoder_layer(mx, cfg["units"], cfg["heads"], cfg["ffn"])
        net.load_parameters(path)
        trainer = mx.gluon.Trainer(net.collect_params(), "adam",
                                   {"learning_rate": cfg["lr"]})
        block = None
        if mode != "eager":
            block = _loss_block(mx, net)
            block.hybridize()
        split, lazy, replays = [], [], []
        inner = _gluon_stepper(mx, trainer, batch, net=net, block=block,
                               split=split, lazy=lazy,
                               read_early=mode == "read_early")

        def step(inner=inner, on=mode != "two_graphs"):
            with _deferred_forward(on):
                return inner()

        def on_step(_i, block=block, trainer=trainer):
            if block is not None:
                replays.append(_graph_replays(block, trainer))

        _dist_counts(zero=True)
        losses, ms = _gluon_loop(step, steps, sync=torch.cuda.synchronize,
                                 on_step=on_step)
        launches = _dist_counts()
        runs[mode] = dict(net=net, trainer=trainer, step=step, block=block,
                          losses=losses, ms=ms, launches=launches,
                          split=list(split), lazy=list(lazy),
                          replays=replays)
    return runs


def _deferred_summary(enc):
    """The lazy forward against the two-graph path (and against the read
    before the step): losses relative, parameters over their max|w|, lazy
    losses and graph replays a step, and the host split of each
    hybridized run."""
    out = {}
    for mode in ("hybrid", "two_graphs", "read_early"):
        r = enc[mode]
        reps = r["replays"]
        split = np.asarray(r["split"][2:])
        out[mode] = dict(
            losses=r["losses"], ms_per_step=float(np.median(r["ms"][2:])),
            lazy=r["lazy"],
            graph_replays_per_step=[b - a for a, b in zip(reps, reps[1:])],
            host_ms_split=dict(zip(("record", "backward", "step"),
                                   np.median(split, axis=0).tolist())))
    for mode in ("hybrid", "read_early"):
        a, b = enc[mode], enc["two_graphs"]
        out[mode]["loss_rel_err_vs_two_graphs"] = max(
            abs(x - y) / abs(y) for x, y in zip(a["losses"], b["losses"]))
        out[mode]["losses_bitwise_equal_two_graphs"] = \
            a["losses"] == b["losses"]
        out[mode]["param_err_vs_two_graphs"] = max(
            float(np.abs(pa.data().asnumpy() - pb.data().asnumpy()).max()
                  / np.abs(pb.data().asnumpy()).max())
            for pa, pb in zip(a["net"].collect_params().values(),
                              b["net"].collect_params().values()))
    return out


def _encoder_grad_norm(torch, mx, run):
    """One more full step of the deferred run with the gradient-norm
    gauge on: ``trainer.grad_norm`` against the host's norm of the
    ``.grad`` buffers."""
    from mxnet_tpu_torch import runtime_metrics as rm
    rm.reset()
    rm.enable()
    rm._GRAD_NORM = True
    try:
        run["step"]()
        gauge = rm.TRAINER_GRAD_NORM.value()
    finally:
        rm._GRAD_NORM = False
        rm.disable()
        rm.reset()
    host = float(np.sqrt(sum(
        (p.grad().asnumpy().astype(np.float64) ** 2).sum()
        for p in run["net"].collect_params().values()
        if p.grad_req != "null")))
    return dict(path="full step", grad_norm=gauge, host_grad_norm=host,
                rel_err=abs(gauge - host) / host)


def _clip_plain(torch, tensors, max_norm):
    """``clip_global_norm``'s function as eager torch ops, in place."""
    total = torch.sqrt(sum(torch.square(torch.linalg.vector_norm(t))
                           for t in tensors))
    scale = torch.where(torch.isfinite(total) & (total > max_norm),
                        max_norm / (total + 1e-8), torch.ones_like(total))
    for t in tensors:
        t.mul_(scale)
    return total


def _clip_on_card(torch, mx, net):
    """``clip_global_norm`` over the layer's ``.grad`` buffers with three
    thresholds (one program, one capture, two replays) against the plain
    torch computation on the card; then the device ms and the host ms of
    a call (with its host read of the norm) of the graph and of the
    plain ops on those buffers."""
    from mxnet_tpu_torch.gluon import utils
    grads = [p.grad() for p in net.collect_params().values()
             if p.grad_req != "null"]
    raw = [g.data_torch.detach().clone() for g in grads]
    norm = float(torch.sqrt(sum(torch.sum(r * r) for r in raw)))
    before = utils.clip_programs()
    rows = []
    for frac in GLUON_HYBRID["clip_fractions"]:
        max_norm = frac * norm
        for g, r in zip(grads, raw):
            g.data_torch.copy_(r)
        got = utils.clip_global_norm(grads, max_norm)
        total = torch.sqrt(sum(torch.sum(r * r) for r in raw))
        scale = max_norm / (total + 1e-8) if float(total) > max_norm else 1.0
        err = max(float((a.data_torch - r * scale).abs().max()
                        / (r * scale).abs().max())
                  for a, r in zip(grads, raw))
        rows.append(dict(max_norm=max_norm, norm=got,
                         plain_norm=float(total),
                         norm_rel_err=abs(got - float(total))
                         / float(total), max_rel_err=err))
    after = utils.clip_programs()
    timer = Timer(torch, torch.device("cuda:0"))
    tensors = [g.data_torch for g in grads]
    max_norm = GLUON_HYBRID["clip_fractions"][-1] * norm

    def host_ms(fn, iters=30):
        ms = []
        for _ in range(iters):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            fn()
            ms.append((time.perf_counter() - t0) * 1e3)
        return float(np.median(ms))

    times = dict(
        graph_ms=timer(lambda: utils.clip_global_norm(
            grads, max_norm, check_isfinite=False)),
        plain_ms=timer(lambda: _clip_plain(torch, tensors, max_norm)),
        graph_host_ms=host_ms(lambda: utils.clip_global_norm(grads,
                                                             max_norm)),
        plain_host_ms=host_ms(lambda: float(_clip_plain(torch, tensors,
                                                        max_norm))),
        bytes=sum(t.numel() * t.element_size() for t in tensors))
    del timer
    return dict(arrays=len(grads), rows=rows, **times,
                **{k: after[k] - before[k] for k in after})


def _instance_pools(torch, block):
    """Each recorded instance of ``block``'s signature with recorded
    instances: the bytes its capture left allocated (``pool_bytes``),
    and the bytes its pool holds now, allocated and reserved, with what
    the Trainer's graphs captured into it since."""
    prog = next(p for p in block._cached_op._cache.values() if p.rec)
    return [dict(at_capture=i.pool_bytes,
                 allocated=_pool_bytes(torch, i.pool),
                 reserved=_pool_reserved(torch, i.pool)) for i in prog.rec]


def _lenet_micro_batches(torch, mx, path, x, y):
    """Gradient accumulation: the hybridized LeNet's ``micro_batches``
    recorded calls under one ``record()``, one ``autograd.backward``,
    against the eager block's; each instance's pool bytes; then a
    ``_fused_update`` step with the gradient-norm gauge on."""
    from mxnet_tpu_torch import runtime_metrics as rm
    k = GLUON_HYBRID["micro_batches"]
    loss_fn = mx.gluon.loss.SoftmaxCrossEntropyLoss()
    grads, nets = {}, {}
    for mode in ("eager", "hybrid"):
        net = _lenet(mx)
        net.load_parameters(path)
        if mode == "hybrid":
            net.hybridize()
        with mx.autograd.record():
            losses = [loss_fn(net(mx.nd.array(a)), mx.nd.array(b))
                      for a, b in zip(np.split(x, k), np.split(y, k))]
        mx.autograd.backward(losses)
        grads[mode] = [p.grad().asnumpy() for p in
                       net.collect_params().values()]
        nets[mode] = net
    err = max(float(np.abs(a - b).max() / np.abs(b).max())
              for a, b in zip(grads["hybrid"], grads["eager"]))
    net = nets["hybrid"]
    prog = next(p for p in net._cached_op._cache.values() if p.rec)
    pools = _instance_pools(torch, net)
    trainer = mx.gluon.Trainer(net.collect_params(), "adam",
                               {"learning_rate": GLUON_LENET["lr"]})
    rm.reset()
    rm.enable()
    rm._GRAD_NORM = True
    try:
        trainer.step(x.shape[0])
        gauge = rm.TRAINER_GRAD_NORM.value()
    finally:
        rm._GRAD_NORM = False
        rm.disable()
        rm.reset()
    host = float(np.sqrt(sum((g.astype(np.float64) ** 2).sum()
                             for g in grads["hybrid"])))
    return dict(calls=k, rows_per_call=x.shape[0] // k,
                grad_rel_err=err, instances=len(prog.rec),
                pool_bytes=pools,
                grad_norm=dict(path="_fused_update", grad_norm=gauge,
                               host_grad_norm=host,
                               rel_err=abs(gauge - host) / host))


def _loss_block(mx, inner):
    """``inner`` (the encoder layer) and its SoftmaxCrossEntropyLoss as
    one HybridBlock: ``block(x, valid_length, label)`` is the loss."""

    class WithLoss(mx.gluon.HybridBlock):
        def __init__(self, **kw):
            super().__init__(**kw)
            with self.name_scope():
                self.inner = inner
                self.loss = mx.gluon.loss.SoftmaxCrossEntropyLoss()

        def hybrid_forward(self, F, x, valid_length, label):
            return self.loss(self.inner(x, valid_length), label)

    return WithLoss()


def _hybrid_predict(torch, mx, path):
    """The layer's inference replay, bucketed lengths and the bounded
    cache, in predict mode."""
    from mxnet_tpu_torch.gluon.block import nb_cached_programs
    cfg = GLUON_FLASH
    hc = GLUON_HYBRID
    net = _encoder_layer(mx, cfg["units"], cfg["heads"], cfg["ffn"])
    net.load_parameters(path)
    x, valid, _y = _encoder_batch(cfg)
    xs, vs = mx.nd.array(x), mx.nd.array(valid)
    out = {}
    with mx.autograd.predict_mode():
        eager = net(xs, vs).asnumpy()
        net.hybridize()
        reps = [net(xs, vs).asnumpy() for _ in range(3)]
        out["replay"] = dict(
            rel_err=max(float(np.abs(r - eager).max()) for r in reps)
            / float(np.abs(eager).max()),
            bitwise_equal=all(bool((r == eager).all()) for r in reps),
            programs=net._cached_op.stats()["programs"])
        # bucketed lengths, padded with zeros on axis 0 up to the next
        # bucket: the valid lengths go in as an (L, B) mask, whose padded
        # rows add nothing to its sum
        masked = _masked(mx, net)
        masked.hybridize(bucket_shapes={0: list(hc["buckets"])})
        n0 = nb_cached_programs()
        counts, got = [], {}
        for L in hc["lengths"] + hc["lengths"]:    # the second pass replays
            got[L] = masked(mx.nd.array(x[:L]), mx.nd.array(
                _mask(valid, L))).asnumpy()
            counts.append(nb_cached_programs() - n0)
        rows = []
        for L in hc["lengths"]:
            v = mx.nd.array(np.minimum(valid, L).astype(np.float32))
            bucket = next(b for b in hc["buckets"] if b >= L)
            xp = np.zeros((bucket,) + x.shape[1:], np.float32)
            xp[:L] = x[:L]
            padded = net(mx.nd.array(xp), v).asnumpy()
            plain = net(mx.nd.array(x[:L]), v).asnumpy()
            rows.append(dict(
                L=L, bucket=bucket,
                rel_err_vs_padded=float(np.abs(got[L] - padded).max()
                                        / np.abs(padded).max()),
                rel_err_vs_unpadded=float(np.abs(got[L] - plain).max()
                                          / np.abs(plain).max())))
        out["buckets"] = dict(buckets=list(hc["buckets"]), rows=rows,
                              programs_after_each_call=counts,
                              programs=masked._cached_op.stats()["programs"])
        del masked
        # the bounded cache: 4 batch sizes through cache_size=2, the two
        # largest first; their programs are evicted by the last two
        net.hybridize(cache_size=hc["cache_size"])
        mem, pools = [], []
        for B in sorted(hc["cache_batches"], reverse=True):
            net(mx.nd.array(x[:, :B]), mx.nd.array(valid[:B]))
            pools.append(net._cached_op.stats()["signatures"][-1][
                "pool_bytes"])
            _free(torch)
            mem.append(torch.cuda.memory_allocated())
        stats = net._cached_op.stats()
        evicted, added = sum(pools[:2]), sum(pools[2:])
        out["cache"] = dict(
            cache_size=hc["cache_size"], evictions=stats["evictions"],
            programs=stats["programs"], pool_bytes=pools,
            memory_allocated=mem, evicted_pool_bytes=evicted,
            # 0 when eviction gave back exactly its pools' bytes
            memory_over_expected=mem[3] - (mem[1] - evicted + added))
    del net
    _free(torch)
    return out


def _mask(valid, L):
    """(L, B) float mask of the first ``min(valid, L)`` rows of each
    column."""
    v = np.minimum(valid, L)
    return (np.arange(L)[:, None] < v[None, :]).astype(np.float32)


def _masked(mx, layer):
    """``layer`` called as ``block(x, mask)`` with the valid lengths as an
    (L, B) mask (padding-safe along L)."""

    class Masked(mx.gluon.HybridBlock):
        def __init__(self, **kw):
            super().__init__(**kw)
            with self.name_scope():
                self.layer = layer

        def hybrid_forward(self, F, x, mask):
            return self.layer(x, mask.sum(axis=0))

    return Masked()


def _hybrid_dropout_bn(torch, mx):
    """Dropout masks across replays; BatchNorm's running statistics,
    hybridized vs eager, after 4 training calls from the same weights."""
    nn = mx.gluon.nn
    drop = nn.HybridSequential()
    drop.add(nn.Dropout(0.5))
    drop.initialize()
    drop.hybridize()
    ones = mx.nd.ones((64, 1024))
    masks = []
    for _ in range(4):
        with mx.autograd.record():
            masks.append(drop(ones).asnumpy())
    differ = [bool((masks[i] != masks[i + 1]).any()) for i in range(3)]
    rs = np.random.RandomState(4)
    nets = []
    for mode in ("eager", "hybrid"):
        mx.random.seed(4)
        net = nn.HybridSequential()
        net.add(nn.Conv2D(16, 3, in_channels=3), nn.BatchNorm(in_channels=16))
        net.initialize(mx.init.Xavier())
        if mode == "hybrid":
            net.hybridize()
        nets.append(net)
    for i in range(4):
        xb = mx.nd.array(rs.randn(32, 3, 16, 16).astype(np.float32))
        for net in nets:
            with mx.autograd.record():
                net(xb).backward()
    bn = [n[1] for n in nets]
    err = max(float(np.abs(getattr(bn[0], s).data().asnumpy()
                           - getattr(bn[1], s).data().asnumpy()).max())
              for s in ("running_mean", "running_var"))
    moved = float(np.abs(bn[1].running_mean.data().asnumpy()).max())
    return dict(dropout_masks_differ=differ, bn_stat_max_abs_err=err,
                bn_running_mean_max=moved)


def _retained_backward_after_step(mx):
    """``backward(retain_graph=True)``, ``Trainer.step``, ``backward``
    on a small Dense net, hybridized and eager, after 3 steps (the
    update replays its graph): whether the second backward raised
    ``MXNetError`` (it would read the updated weights)."""
    nn = mx.gluon.nn
    x = mx.nd.array(np.random.RandomState(5).randn(8, 16).astype(
        np.float32))
    out = {}
    for mode in ("hybrid", "eager"):
        net = nn.HybridSequential()
        net.add(nn.Dense(32, activation="relu", in_units=16),
                nn.Dense(4, in_units=32))
        net.initialize(mx.init.Xavier())
        if mode == "hybrid":
            net.hybridize()
        trainer = mx.gluon.Trainer(net.collect_params(), "adam",
                                   {"learning_rate": 1e-3})
        for _ in range(4):
            with mx.autograd.record():
                loss = (net(x) ** 2).mean()
            loss.backward(retain_graph=True)
            trainer.step(8)
        try:
            loss.backward()
            out[mode] = "no error"
        except mx.MXNetError as e:
            out[mode] = str(e)
    return out


def phase_gluon_hybrid(torch):
    """``gluon_hybrid``: the Gluon loop with ``net.hybridize()`` (module
    comment above ``GLUON_HYBRID``).  Returns B1-B3's wrapper launches in
    the encoder layer's hybridized run and their records in its traced
    steps."""
    import mxnet_tpu_torch as mx
    from mxnet_tpu_torch.gluon.block import nb_cached_programs
    rs = np.random.RandomState(0)
    lx = rs.rand(GLUON_LENET["batch"], 1, 28, 28).astype(np.float32)
    ly = rs.randint(0, 10, GLUON_LENET["batch"]).astype(np.float32)
    ex, ev, ey = _encoder_batch(GLUON_FLASH)
    tmp = tempfile.mkdtemp(prefix="mxnet-gluon-hybrid-")
    try:
        lpath = os.path.join(tmp, "lenet.npz")
        epath = os.path.join(tmp, "encoder.npz")
        _lenet_weights(mx, lpath, lx)
        _encoder_weights(mx, GLUON_FLASH, epath)
        with mx.gpu(0):
            lenet = _hybrid_lenet(torch, mx, lpath, lx, ly)
            lenet_err = _gluon_param_err(lenet["hybrid"]["net"],
                                   lenet["eager"]["net"])
            lenet_trace = {m: _hybrid_trace(torch, r, f"lenet {m}")
                           for m, r in lenet.items()}
            lenet_cop = lenet["hybrid"]["net"]._cached_op.stats()
            lenet_fused = lenet["hybrid"]["trainer"].fused_stats()
            lenet_pools = _instance_pools(torch, lenet["hybrid"]["net"])
            for r in lenet.values():
                r.pop("net"), r.pop("trainer"), r.pop("step")
            _free(torch)
            micro = _lenet_micro_batches(torch, mx, lpath, lx, ly)
            _free(torch)
            batch = tuple(mx.nd.array(a) for a in (ex, ev, ey))
            enc = _hybrid_encoder(torch, mx, epath, batch)
            enc_err = _gluon_param_err(enc["hybrid"]["net"],
                                       enc["eager"]["net"])
            deferred = _deferred_summary(enc)
            n_before = nb_cached_programs()
            enc_trace, graph_launches = {}, {}
            for m in ("eager", "hybrid", "two_graphs"):
                enc_trace[m] = _hybrid_trace(torch, enc[m], f"encoder {m}")
                graph_launches[m] = TRACE_LAUNCHES[-1]["counted"]
            enc_programs_grew = nb_cached_programs() - n_before
            enc_cop = enc["hybrid"]["block"]._cached_op.stats()
            enc_fused = enc["hybrid"]["trainer"].fused_stats()
            inst = next(iter(enc["hybrid"]["block"]._cached_op._cache
                             .values())).rec[0]
            fused_entries = [dict(key=k[0] if k[0] == "full"
                                  else "backward + update",
                                  replays=e.replays, capture_s=e.capture_s,
                                  binding_copies=e.copies)
                             for k, e in inst.fused[
                                 enc["hybrid"]["trainer"]].items()]
            pools = {m: _instance_pools(torch, enc[m]["block"])
                     for m in ("hybrid", "two_graphs", "read_early")}
            grad_norm = _encoder_grad_norm(torch, mx, enc["hybrid"])
            clip = _clip_on_card(torch, mx, enc["hybrid"]["net"])
            for r in enc.values():
                for k in ("net", "trainer", "step", "block"):
                    r.pop(k)
            del inst
            _free(torch)
            predict = _hybrid_predict(torch, mx, epath)
            small = _hybrid_dropout_bn(torch, mx)
            retained = _retained_backward_after_step(mx)
        _free(torch)
    finally:
        shutil.rmtree(tmp, ignore_errors=True)

    def summary(runs):
        out = {}
        for mode, r in runs.items():
            out[mode] = dict(losses=r["losses"], first_step_ms=r["ms"][0],
                             second_step_ms=r["ms"][1],
                             ms_per_step=float(np.median(r["ms"][2:])))
        first = [runs[m]["losses"][0] for m in ("hybrid", "eager")]
        out["first_loss_rel_err"] = abs(first[0] - first[1]) / abs(first[1])
        out["first_loss_bitwise_equal"] = first[0] == first[1]
        out["loss_rel_err"] = max(abs(a - b) / abs(b) for a, b in zip(
            runs["hybrid"]["losses"], runs["eager"]["losses"]))
        out["losses_bitwise_equal"] = \
            runs["hybrid"]["losses"] == runs["eager"]["losses"]
        return out

    lenet_sum = summary(lenet)
    enc_sum = summary({m: enc[m] for m in ("eager", "hybrid")})
    launches = enc["hybrid"]["launches"]
    traced = enc_trace["hybrid"]["records_per_step"]
    emit("gluon_hybrid", dtype="float32",
         lenet=dict(model="lenet (examples/mnist_gluon.py)",
                    batch=GLUON_LENET["batch"],
                    steps=GLUON_HYBRID["lenet_steps"], optimizer="adam",
                    lr=GLUON_LENET["lr"], path="forward + backward graphs, "
                    "_fused_update graph", **lenet_sum,
                    param_err_of_tol=lenet_err,
                    programs_after_each_step=lenet["hybrid"]["programs"],
                    cached_op=dict(param_copies=lenet_cop["param_copies"],
                                   replays=lenet_cop["replays"],
                                   signatures=_sig_stats_rows(lenet_cop)),
                    trainer=lenet_fused, instance_pools=lenet_pools,
                    trace=lenet_trace),
         encoder=dict(layer="bert_24_1024_16 encoder layer + "
                      "SoftmaxCrossEntropyLoss in one HybridBlock",
                      **{k: GLUON_FLASH[k] for k in ("units", "heads", "ffn",
                                                     "L", "B")},
                      steps=GLUON_HYBRID["encoder_steps"], optimizer="adam",
                      lr=GLUON_FLASH["lr"], path="lazy forward: one "
                      "full-step graph (forward, backward, update)",
                      **enc_sum, param_err_of_tol=enc_err,
                      deferred=deferred,
                      graph_launches_per_traced_step={
                          m: len(v) / GLUON_HYBRID["traced_steps"]
                          for m, v in graph_launches.items()},
                      launches=enc["hybrid"]["launches"],
                      launches_two_graphs=enc["two_graphs"]["launches"],
                      launches_eager=enc["eager"]["launches"],
                      programs_grew_while_traced=enc_programs_grew,
                      cached_op=dict(param_copies=enc_cop["param_copies"],
                                     replays=enc_cop["replays"],
                                     signatures=_sig_stats_rows(enc_cop)),
                      fused_entries=fused_entries, trainer=enc_fused,
                      instance_pools=pools,
                      trace=enc_trace),
         micro_batches=micro, grad_norm=grad_norm, clip_global_norm=clip,
         predict=predict, dropout_batchnorm=small,
         retained_backward_after_step=retained,
         loss_rtol=GLUON_HYBRID_LOSS_RTOL,
         first_loss_rtol=GLUON_HYBRID_FIRST_RTOL,
         param_tol=GLUON_HYBRID_PARAM_TOL)
    for name, s, err in (("lenet", lenet_sum, lenet_err),
                         ("encoder", enc_sum, enc_err)):
        check(all(np.isfinite(s["hybrid"]["losses"])),
              f"gluon_hybrid {name}: losses {s['hybrid']['losses']}")
        check(s["first_loss_rel_err"] <= GLUON_HYBRID_FIRST_RTOL,
              f"gluon_hybrid {name}: first loss {s['first_loss_rel_err']} "
              f"from eager")
        check(s["loss_rel_err"] <= GLUON_HYBRID_LOSS_RTOL,
              f"gluon_hybrid {name}: losses {s['loss_rel_err']} from eager")
        check(err <= 1.0, f"gluon_hybrid {name}: parameters {err} of "
                          f"{GLUON_HYBRID_PARAM_TOL} from eager")
    progs = lenet["hybrid"]["programs"]
    check(len(set(progs)) == 1,
          f"gluon_hybrid lenet: programs grew after the first call {progs}")
    check(enc_programs_grew == 0,
          f"gluon_hybrid encoder: {enc_programs_grew} programs while traced")
    for cop, name in ((lenet_cop, "lenet"), (enc_cop, "encoder")):
        check(cop["param_copies"] == 0,
              f"gluon_hybrid {name}: {cop['param_copies']} parameter "
              f"copies on the fused path")
    check(enc_fused["binding_copies"] == 0
          and all(e["binding_copies"] == 0 for e in fused_entries)
          and lenet_fused["binding_copies"] == 0,
          f"gluon_hybrid: trainer binding copies {enc_fused} "
          f"{fused_entries} {lenet_fused}")
    check(len(fused_entries) == 1 and fused_entries[0]["key"] == "full"
          and fused_entries[0]["replays"] > 0,
          f"gluon_hybrid encoder: fused entries {fused_entries}")
    for mode in ("hybrid", "two_graphs"):
        rec = enc_trace[mode]["records_per_step"]
        check(rec == dict.fromkeys(FLASH_NAMES, 1.0),
              f"gluon_hybrid encoder {mode}: B1-B3 records per traced "
              f"step {rec}")
    check(len(graph_launches["hybrid"]) == GLUON_HYBRID["traced_steps"],
          f"gluon_hybrid encoder: {graph_launches['hybrid']} graph "
          f"launches in {GLUON_HYBRID['traced_steps']} traced lazy steps")
    d = deferred["hybrid"]
    check(d["lazy"] == [False] + [True] * (GLUON_HYBRID["encoder_steps"] - 1)
          and deferred["two_graphs"]["lazy"]
          == [False] * GLUON_HYBRID["encoder_steps"],
          f"gluon_hybrid deferred: lazy losses {d['lazy']} "
          f"{deferred['two_graphs']['lazy']}")
    # step 2 runs the full step eagerly and captures it; later steps
    # replay its graph and nothing else
    check(d["graph_replays_per_step"][1:]
          == [1] * (GLUON_HYBRID["encoder_steps"] - 2),
          f"gluon_hybrid deferred: graph replays a step "
          f"{d['graph_replays_per_step']}")
    for mode in ("hybrid", "read_early"):
        dm = deferred[mode]
        check(dm["loss_rel_err_vs_two_graphs"] <= GLUON_HYBRID_DEFERRED_TOL
              and dm["param_err_vs_two_graphs"] <= GLUON_HYBRID_DEFERRED_TOL,
              f"gluon_hybrid deferred {mode} vs the two-graph path: {dm}")
    for name, g in (("lenet", micro["grad_norm"]), ("encoder", grad_norm)):
        check(g["rel_err"] <= GLUON_HYBRID_GRAD_NORM_RTOL,
              f"gluon_hybrid {name}: trainer.grad_norm {g}")
    check(micro["grad_rel_err"] <= GLUON_LENET_RTOL[0]
          and micro["instances"] >= GLUON_HYBRID["micro_batches"] - 1,
          f"gluon_hybrid: {GLUON_HYBRID['micro_batches']} recorded calls "
          f"before one backward: {micro}")
    check(clip["programs"] == 1 and clip["captures"] == 1
          and clip["replays"] == len(GLUON_HYBRID["clip_fractions"]) - 1
          and all(r["max_rel_err"] <= GLUON_HYBRID_CLIP_TOL
                  and r["norm_rel_err"] <= GLUON_HYBRID_CLIP_TOL
                  for r in clip["rows"]),
          f"gluon_hybrid: clip_global_norm {clip}")
    check(all(v >= 1 for v in launches.values()),
          f"gluon_hybrid encoder: B1-B3 wrapper launches {launches}")
    rep = predict["replay"]
    check(rep["rel_err"] <= GLUON_HYBRID_BUCKET_TOL[0],
          f"gluon_hybrid predict: replay {rep}")
    bk = predict["buckets"]
    n_l = len(GLUON_HYBRID["lengths"])
    check(bk["programs"] == 3 and bk["programs_after_each_call"][n_l:]
          == [bk["programs_after_each_call"][n_l - 1]] * n_l,
          f"gluon_hybrid buckets: programs {bk}")
    for row in bk["rows"]:
        check(row["rel_err_vs_padded"] <= GLUON_HYBRID_BUCKET_TOL[0]
              and row["rel_err_vs_unpadded"] <= GLUON_HYBRID_BUCKET_TOL[1],
              f"gluon_hybrid buckets: {row}")
    ca = predict["cache"]
    check(ca["evictions"] == 2 and ca["programs"] == 2,
          f"gluon_hybrid cache: {ca}")
    check(ca["memory_over_expected"] <= GLUON_HYBRID_CACHE_SLACK,
          f"gluon_hybrid cache: eviction left "
          f"{ca['memory_over_expected']} bytes over the evicted pools")
    check(all(small["dropout_masks_differ"])
          and small["bn_stat_max_abs_err"] <= GLUON_HYBRID_BN_TOL
          and small["bn_running_mean_max"] > 0,
          f"gluon_hybrid dropout / batchnorm: {small}")
    check(all("in place" in v for v in retained.values()),
          f"gluon_hybrid: a backward after the step that updated its "
          f"weights did not refuse: {retained}")
    ht = enc_trace["hybrid"]
    return dict(launches=launches,
                traced={k: v * GLUON_HYBRID["traced_steps"]
                        for k, v in traced.items()},
                encoder=dict(ms_per_step=enc_sum["hybrid"]["ms_per_step"],
                             **{k: ht[k] for k in (
                                 "step_ms_host", "device_ms_per_step",
                                 "device_idle_share",
                                 "host_calls_per_step")}))


# ------------------------------------------------------------- gluon_mnist
# examples/mnist_gluon.py's training loop through the port at its
# published settings: the synthetic MNIST (8192 images: no files under
# root), DataLoader(batch_size=64, shuffle=True) after np.random.seed(42),
# the hybridized LeNet (static_alloc=True), Adam at lr 1e-3,
# SoftmaxCrossEntropyLoss and mx.metric.Accuracy, one epoch (128 steps).
GLUON_MNIST = dict(batch=64, lr=1e-3, seed=42, host_steps=3,
                   loader_batches=8, workers=2, property_reads=200000)
# the epoch's accuracy over the synthetic set (chance is 0.1)
GLUON_MNIST_MIN_ACCURACY = 0.5


def _mnist_loader(mx, train, **kw):
    np.random.seed(GLUON_MNIST["seed"])
    return mx.gluon.data.DataLoader(train, batch_size=GLUON_MNIST["batch"],
                                    shuffle=True, **kw)


def _mnist_step(mx, net, trainer, loss_fn, x, y):
    """The example's step: scale the uint8 NHWC batch, record, backward,
    step; returns (output, loss)."""
    x = x.astype("float32").transpose((0, 3, 1, 2)) / 255.0
    with mx.autograd.record():
        out = net(x)
        loss = loss_fn(out, y)
    loss.backward()
    trainer.step(x.shape[0])
    return out, loss


def _data_property_cost(torch, mx, net, loss_fn, x, y):
    """What the lazy state costs an eager LeNet step: ``NDArray._data``
    reads in one step, times the property's cost over a plain slot read
    (``timeit`` on the host)."""
    import timeit
    from mxnet_tpu_torch.ndarray import NDArray
    trainer = mx.gluon.Trainer(net.collect_params(), "adam",
                               {"learning_rate": GLUON_MNIST["lr"]})
    _mnist_step(mx, net, trainer, loss_fn, x, y)
    torch.cuda.synchronize()
    prop, reads = NDArray.__dict__["_data"], [0]

    def counted(arr):
        reads[0] += 1
        return prop.fget(arr)

    NDArray._data = property(counted, prop.fset)
    try:
        _mnist_step(mx, net, trainer, loss_fn, x, y)
    finally:
        NDArray._data = prop
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    _mnist_step(mx, net, trainer, loss_fn, x, y)
    torch.cuda.synchronize()
    step_ms = (time.perf_counter() - t0) * 1e3
    a, n = x, GLUON_MNIST["property_reads"]
    t_prop = timeit.timeit(lambda: a._data, number=n) / n
    t_slot = timeit.timeit(lambda: a._t, number=n) / n
    return dict(reads_per_step=reads[0], property_ns=t_prop * 1e9,
                slot_ns=t_slot * 1e9,
                cost_us_per_step=reads[0] * (t_prop - t_slot) * 1e6,
                eager_step_ms=step_ms)


def phase_gluon_mnist(torch):
    """``gluon_mnist``: examples/mnist_gluon.py's loop on the card (module
    comment above ``GLUON_MNIST``), its first steps against the same
    weights and batches on the host, a second loader with workers and
    pinned memory, and the host cost of the lazy state on an eager
    step."""
    import mxnet_tpu_torch as mx
    cfg = GLUON_MNIST
    tmp = tempfile.mkdtemp(prefix="mxnet-gluon-mnist-")
    try:
        path = os.path.join(tmp, "lenet.npz")
        _lenet_weights(mx, path, np.zeros((1, 1, 28, 28), np.float32))
        train = mx.gluon.data.vision.MNIST(root=os.path.join(tmp, "mnist"),
                                           train=True)
        loss_fn = mx.gluon.loss.SoftmaxCrossEntropyLoss()
        with mx.gpu(0):
            net = _lenet(mx)
            net.load_parameters(path)
            net.hybridize(static_alloc=True)
            trainer = mx.gluon.Trainer(net.collect_params(), "adam",
                                       {"learning_rate": cfg["lr"]})
            metric = mx.metric.Accuracy()
            loader = _mnist_loader(mx, train)
            steps = len(loader)
            it = iter(loader)
            t_next, t_train, t_metric, losses, first = [], [], [], [], []
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            for i in range(steps):
                ta = time.perf_counter()
                x, y = next(it)
                tb = time.perf_counter()
                out, loss = _mnist_step(mx, net, trainer, loss_fn, x, y)
                tc = time.perf_counter()
                metric.update(y, out)
                td = time.perf_counter()
                t_next.append((tb - ta) * 1e3)
                t_train.append((tc - tb) * 1e3)
                t_metric.append((td - tc) * 1e3)
                losses.append(loss)
                if i < cfg["loader_batches"]:
                    first.append((x, y))
            torch.cuda.synchronize()
            epoch_s = time.perf_counter() - t0
            acc_name, acc = metric.get()
            losses = [float(v.mean().asscalar()) for v in losses]
            devices = sorted({str(first[0][0].data_torch.device),
                              str(first[0][1].data_torch.device),
                              str(net[0].weight.data().data_torch.device)})
            with _mnist_loader(mx, train, num_workers=cfg["workers"],
                               pin_memory=True) as pinned:
                again = [b for _i, b in zip(range(cfg["loader_batches"]),
                                            pinned)]
            same = all(bool((a.data_torch == b.data_torch).all())
                       for (xa, ya), (xb, yb) in zip(first, again)
                       for a, b in ((xa, xb), (ya, yb)))
            pinned_ctx = str(again[0][0].context)
            host_batches = [(x.asnumpy(), y.asnumpy())
                            for x, y in first[:cfg["host_steps"]]]
            eager = _lenet(mx)
            eager.load_parameters(path)
            cost = _data_property_cost(torch, mx, eager, loss_fn,
                                       *first[0])
            del net, trainer, first, again, eager
        with mx.cpu(0):
            host = _lenet(mx)
            host.load_parameters(path)
            host.hybridize(static_alloc=True)
            htrainer = mx.gluon.Trainer(host.collect_params(), "adam",
                                        {"learning_rate": cfg["lr"]})
            host_losses = [float(_mnist_step(
                mx, host, htrainer, loss_fn, mx.nd.array(x, dtype="uint8"),
                mx.nd.array(y, dtype="int32"))[1].mean().asscalar())
                for x, y in host_batches]
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    _free(torch)
    rel = [abs(a - b) / abs(b) for a, b in zip(losses, host_losses)]
    head, tail = float(np.mean(losses[:8])), float(np.mean(losses[-8:]))
    emit("gluon_mnist", example="examples/mnist_gluon.py",
         dataset="MNIST (synthetic)", synthetic=train.synthetic,
         images=len(train), batch=cfg["batch"], steps=steps,
         optimizer="adam", lr=cfg["lr"], dtype="float32", devices=devices,
         seconds_per_epoch=epoch_s, metric=acc_name, accuracy=acc,
         first_losses=losses[:8], last_losses=losses[-8:],
         mean_loss_first8=head, mean_loss_last8=tail,
         host_losses=host_losses, loss_rel_err=rel,
         loss_rtol=GLUON_LENET_RTOL,
         step_ms_split=dict(next_loader=float(np.median(t_next)),
                            forward_backward_step=float(np.median(t_train)),
                            metric_update=float(np.median(t_metric))),
         step_ms_split_mean=dict(
             next_loader=float(np.mean(t_next)),
             forward_backward_step=float(np.mean(t_train)),
             metric_update=float(np.mean(t_metric))),
         pinned_loader=dict(workers=cfg["workers"], context=pinned_ctx,
                            batches=cfg["loader_batches"],
                            bitwise_equal=same),
         data_property=cost)
    check(train.synthetic and len(train) == 8192 and steps == 128,
          f"gluon_mnist: dataset {len(train)} images, {steps} steps")
    check(all(d.startswith("cuda") for d in devices),
          f"gluon_mnist: batches and weights on {devices}")
    check(all(np.isfinite(losses)) and tail < head,
          f"gluon_mnist: losses {head} -> {tail}")
    check(all(e <= t for e, t in zip(rel, GLUON_LENET_RTOL)),
          f"gluon_mnist: card vs host losses {rel}, want {GLUON_LENET_RTOL}")
    check(acc > GLUON_MNIST_MIN_ACCURACY,
          f"gluon_mnist: accuracy {acc} over the epoch")
    check(same and pinned_ctx.startswith("gpu"),
          f"gluon_mnist: the pinned loader's batches differ ({pinned_ctx})")


# --------------------------------------------------------------- gluon_ssd
# examples/ssd_detection.py's loop through the port at its published
# settings: TinySSD (32x32 inputs, one 8x8 scale, K = 4 anchors a cell,
# so N = 256), batch 32, 150 iterations, Adam lr 5e-3, Xavier after
# mx.random.seed(0), RandomState(0) data, MultiBoxTarget with hard
# negatives (ratio 3) under autograd.pause, SoftmaxCrossEntropyLoss +
# smooth_l1; then 64 images through nd.softmax and
# MultiBoxDetection(nms_threshold=0.45), scored by the example's mIoU of
# each image's top detection.  The weights are drawn on the host and
# loaded on the card, so the host run starts from them too.
GLUON_SSD = dict(img=32, classes=2, batch=32, iters=150, lr=5e-3,
                 eval_images=64, nms_threshold=0.45, host_steps=3)
# the example's own bar (its assert)
GLUON_SSD_MIN_MIOU = 0.4
# the hybridized TinySSD forward against the eager one, of each output's
# max|value|
GLUON_SSD_HYBRID_TOL = 1e-5


def _ssd_batch(mx, rng, n):
    """``synth_batch`` of examples/ssd_detection.py: images with one
    square, label rows [cls, xmin, ymin, xmax, ymax] (numpy)."""
    img = GLUON_SSD["img"]
    imgs = np.zeros((n, 1, img, img), np.float32)
    labels = np.zeros((n, 1, 5), np.float32)
    for i in range(n):
        size = rng.randint(8, 16)
        x0 = rng.randint(0, img - size)
        y0 = rng.randint(0, img - size)
        cls = rng.randint(0, GLUON_SSD["classes"])
        imgs[i, 0, y0:y0 + size, x0:x0 + size] = 0.4 if cls == 0 else 0.9
        labels[i, 0] = [cls, x0 / img, y0 / img, (x0 + size) / img,
                        (y0 + size) / img]
    return imgs, labels


def _tiny_ssd(mx):
    """examples/ssd_detection.py's TinySSD on the port."""
    nn = mx.gluon.nn
    n_cls = GLUON_SSD["classes"]

    class TinySSD(mx.gluon.HybridBlock):
        SIZES = (0.3, 0.45)
        RATIOS = (1.0, 2.0, 0.5)
        K = len(SIZES) + len(RATIOS) - 1

        def __init__(self, **kwargs):
            super().__init__(**kwargs)
            with self.name_scope():
                self.backbone = nn.HybridSequential()
                self.backbone.add(
                    nn.Conv2D(16, 3, padding=1, activation="relu"),
                    nn.MaxPool2D(2, 2),
                    nn.Conv2D(32, 3, padding=1, activation="relu"),
                    nn.MaxPool2D(2, 2),
                    nn.Conv2D(64, 3, padding=1, activation="relu"))
                self.cls_head = nn.Conv2D(self.K * (n_cls + 1), 3,
                                          padding=1)
                self.box_head = nn.Conv2D(self.K * 4, 3, padding=1)

        def hybrid_forward(self, F, x):
            feat = self.backbone(x)
            anchors = F.MultiBoxPrior(feat, sizes=self.SIZES,
                                      ratios=self.RATIOS)
            cls = self.cls_head(feat)
            box = self.box_head(feat)
            B = cls.shape[0]
            cls = cls.transpose((0, 2, 3, 1)).reshape(
                (B, -1, n_cls + 1)).transpose((0, 2, 1))
            box = box.transpose((0, 2, 3, 1)).reshape((B, -1))
            return anchors, cls, box

    return TinySSD()


def _ssd_weights(mx, path):
    """TinySSD's weights from seed 0 (Xavier, drawn on the host), saved."""
    mx.random.seed(0)
    with mx.cpu(0):
        net = _tiny_ssd(mx)
        net.initialize(mx.init.Xavier())
        img = GLUON_SSD["img"]
        net(mx.nd.zeros((1, 1, img, img)))
        net.save_parameters(path)


def _ssd_step(mx, net, trainer, ce, imgs, labels, marks=None):
    """One iteration of the example's loop; returns (loss, cls_l, box_l).
    ``marks(tag)`` is called after the forward, MultiBoxTarget, the loss,
    the backward and the step."""
    nd, n_cls = mx.nd, GLUON_SSD["classes"]
    mark = marks or (lambda tag: None)
    with mx.autograd.record():
        anchors, cls_pred, box_pred = net(imgs)
        mark("forward")
        with mx.autograd.pause():
            box_t, box_m, cls_t = nd.MultiBoxTarget(
                anchors, labels, cls_pred, negative_mining_ratio=3.0)
        mark("multibox_target")
        cls_l = ce(cls_pred.transpose((0, 2, 1)).reshape((-1, n_cls + 1)),
                   cls_t.reshape((-1,)))
        w = (cls_t.reshape((-1,)) >= 0)
        cls_l = (cls_l * w).sum() / w.sum()
        box_l = (nd.smooth_l1(box_pred - box_t) * box_m).sum() \
            / box_m.sum().clip(1.0, None)
        loss = cls_l + box_l
        mark("loss")
    loss.backward()
    mark("backward")
    trainer.step(imgs.shape[0])
    mark("step")
    return loss, cls_l, box_l


def _ssd_eval(mx, net, imgs, labels, marks=None):
    """The example's evaluation: (mIoU, class accuracy) of each image's
    best-scoring detection."""
    nd = mx.nd
    anchors, cls_pred, box_pred = net(imgs)
    cls_prob = nd.softmax(cls_pred, axis=1)
    if marks:
        marks("forward")
    dets = nd.MultiBoxDetection(cls_prob, box_pred, anchors,
                                nms_threshold=GLUON_SSD["nms_threshold"])
    if marks:
        marks("multibox_detection")
    dets = dets.asnumpy()
    ious, hits = [], []
    for top, gt in zip(dets[:, 0], labels[:, 0]):
        bx, gx = top[2:], gt[1:]
        ix = max(0.0, min(bx[2], gx[2]) - max(bx[0], gx[0]))
        iy = max(0.0, min(bx[3], gx[3]) - max(bx[1], gx[1]))
        inter = ix * iy
        union = ((bx[2] - bx[0]) * (bx[3] - bx[1])
                 + (gx[2] - gx[0]) * (gx[3] - gx[1]) - inter)
        ious.append(inter / max(union, 1e-9))
        hits.append(float(top[0] == gt[0]))
    return float(np.mean(ious)), float(np.mean(hits))


class _Marks:
    """Host ms between consecutive ``mark`` calls, the card synchronised
    at each (so each part's ms holds its device work)."""

    def __init__(self, torch):
        self.torch, self.ms = torch, collections.defaultdict(list)
        self.start()

    def start(self):
        self.torch.cuda.synchronize()
        self.t = time.perf_counter()

    def __call__(self, tag):
        self.torch.cuda.synchronize()
        now = time.perf_counter()
        self.ms[tag].append((now - self.t) * 1e3)
        self.t = now

    def median(self):
        return {k: float(np.median(v)) for k, v in self.ms.items()}


def phase_gluon_ssd(torch):
    """``gluon_ssd``: examples/ssd_detection.py's training loop and
    evaluation on the card (module comment above ``GLUON_SSD``), its
    first iterations against the host from the same weights and batches,
    and the hybridized TinySSD forward (MultiBoxPrior inside its CUDA
    graph) against the eager one."""
    import mxnet_tpu_torch as mx
    from mxnet_tpu_torch.ops import registry
    cfg = GLUON_SSD
    tmp = tempfile.mkdtemp(prefix="mxnet-gluon-ssd-")
    try:
        path = os.path.join(tmp, "ssd.npz")
        _ssd_weights(mx, path)
        rng = np.random.RandomState(0)
        batches = [_ssd_batch(mx, rng, cfg["batch"])
                   for _ in range(cfg["iters"])]
        eval_imgs, eval_labels = _ssd_batch(mx, rng, cfg["eval_images"])
        ce = mx.gluon.loss.SoftmaxCrossEntropyLoss()
        with mx.gpu(0):
            net = _tiny_ssd(mx)
            net.load_parameters(path)
            trainer = mx.gluon.Trainer(net.collect_params(), "adam",
                                       {"learning_rate": cfg["lr"]})
            marks = _Marks(torch)
            t0 = time.perf_counter()
            losses = []
            for imgs, labels in batches:
                marks.start()
                loss, _c, _b = _ssd_step(
                    mx, net, trainer, ce, mx.nd.array(imgs),
                    mx.nd.array(labels), marks)
                losses.append(loss)
            torch.cuda.synchronize()
            train_s = time.perf_counter() - t0
            losses = [float(v.asscalar()) for v in losses]
            train_split = marks.median()
            emarks = _Marks(torch)
            miou, acc = _ssd_eval(mx, net, mx.nd.array(eval_imgs),
                                  eval_labels, emarks)
            eval_split = emarks.median()
            # the hybridized forward against the eager one, same weights
            x = mx.nd.array(eval_imgs)
            eager = [o.asnumpy() for o in net(x)]
            net.hybridize()
            prior = registry.get_op("MultiBoxPrior")
            calls, fn = [0], prior.fn

            def counted(*a, **k):
                calls[0] += 1
                return fn(*a, **k)

            prior.fn = counted
            try:
                net(x)                    # eager warm-up, then capture
                before = calls[0]
                hybrid = [o.asnumpy() for o in net(x)]
                replay_calls = calls[0] - before
            finally:
                prior.fn = fn
            stats = net._cached_op.stats()
            hyb_err = [float(np.abs(h - e).max() / max(np.abs(e).max(),
                                                       1e-30))
                       for h, e in zip(hybrid, eager)]
            devices = sorted({str(p.data().data_torch.device)
                              for p in net.collect_params().values()})
            del net, trainer
        with mx.cpu(0):
            host = _tiny_ssd(mx)
            host.load_parameters(path)
            htrainer = mx.gluon.Trainer(host.collect_params(), "adam",
                                        {"learning_rate": cfg["lr"]})
            host_losses = [float(_ssd_step(
                mx, host, htrainer, ce, mx.nd.array(imgs),
                mx.nd.array(labels))[0].asscalar())
                for imgs, labels in batches[:cfg["host_steps"]]]
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    _free(torch)
    rel = [abs(a - b) / abs(b) for a, b in zip(losses, host_losses)]
    head, tail = float(np.mean(losses[:10])), float(np.mean(losses[-10:]))
    emit("gluon_ssd", example="examples/ssd_detection.py",
         model="TinySSD", anchors=256, batch=cfg["batch"],
         iters=cfg["iters"], optimizer="adam", lr=cfg["lr"],
         dtype="float32", devices=devices, train_seconds=train_s,
         iter_ms_split=train_split,
         iter_ms=float(sum(train_split.values())),
         eval_images=cfg["eval_images"], eval_ms_split=eval_split,
         mean_iou=miou, class_accuracy=acc,
         first_losses=losses[:5], last_losses=losses[-5:],
         mean_loss_first10=head, mean_loss_last10=tail,
         host_losses=host_losses, loss_rel_err=rel,
         loss_rtol=GLUON_LENET_RTOL, hybrid_rel_err=hyb_err,
         hybrid_programs=stats["programs"],
         hybrid_replays=stats["replays"],
         multibox_prior_calls_in_replay=replay_calls)
    check(all(d.startswith("cuda") for d in devices),
          f"gluon_ssd: weights on {devices}")
    check(all(np.isfinite(losses)) and tail < head,
          f"gluon_ssd: losses {head} -> {tail}")
    check(all(e <= t for e, t in zip(rel, GLUON_LENET_RTOL)),
          f"gluon_ssd: card vs host losses {rel}, want {GLUON_LENET_RTOL}")
    check(miou > GLUON_SSD_MIN_MIOU,
          f"gluon_ssd: the detector did not localize (mIoU {miou})")
    check(all(e <= GLUON_SSD_HYBRID_TOL for e in hyb_err),
          f"gluon_ssd: hybridized vs eager forward {hyb_err}")
    check(stats["programs"] == 1 and stats["replays"] >= 1
          and replay_calls == 0,
          f"gluon_ssd: the hybridized forward did not replay one graph "
          f"holding MultiBoxPrior ({stats}, {replay_calls} calls)")


# ------------------------------------------------------------- gluon_fused
# gluon.contrib.FusedTrainStep (one CUDA graph a step: the forward with B1,
# the backward with B2 and B3, Adam) on gluon_flash's BERT-large-width
# encoder layer with its loss, against the three-call recipe (the
# hybridized loss block under record / backward / Trainer.step: the lazy
# forward's full-step graph) from the same weights and batch, fp32 with
# TF32 off: 3 steps each, losses within GLUON_HYBRID_LOSS_RTOL (the first
# within GLUON_HYBRID_FIRST_RTOL: both are eager calls of the same
# kernels) and parameters within GLUON_HYBRID_PARAM_TOL (a replay runs
# the same kernels, but cuBLAS picks its algorithm per stream and
# workspace, and Adam's normalised step turns such rounding of a
# near-zero gradient into up to lr); then timed and traced steps, the
# .grad buffers untouched, and a failure injected after the launch (the
# graph's replay raising) poisoning the instance until a reload and
# reset().
GLUON_FUSED = dict(steps=3, timed_steps=10, traced_steps=3)


def _fused_runs(mx, path, batch):
    """The encoder layer with its loss from ``path``'s weights, twice:
    trained by ``FusedTrainStep`` and by the three-call recipe."""
    from mxnet_tpu_torch.gluon.contrib import FusedTrainStep
    cfg = GLUON_FLASH
    runs = {}
    for mode in ("fused", "three_call"):
        net = _encoder_layer(mx, cfg["units"], cfg["heads"], cfg["ffn"])
        net.load_parameters(path)
        trainer = mx.gluon.Trainer(net.collect_params(), "adam",
                                   {"learning_rate": cfg["lr"]})
        block = _loss_block(mx, net)
        if mode == "fused":
            fused = FusedTrainStep(block, trainer)
            # the batch is (L, B, units): B examples, as trainer.step's
            step = functools.partial(fused, *batch,
                                     batch_size=batch[-1].shape[0])
        else:
            block.hybridize()
            fused = None
            step = _gluon_stepper(mx, trainer, batch, block=block)
        runs[mode] = dict(net=net, trainer=trainer, fused=fused, step=step)
    return runs


class _FailingGraph:
    """A CUDA graph stand-in whose replay fails after the launch."""

    def replay(self):
        raise RuntimeError("injected failure after the launch")


def _fused_poison(torch, mx, run, path, batch):
    """A failure injected into the fused step's replay: the error names
    the donated buffers, the next call refuses until ``reset()``, the
    update counts roll back; after a reload and ``reset()`` the step
    captures its graph anew and trains."""
    from mxnet_tpu_torch.base import KernelError
    fused, o = run["fused"], run["trainer"]._optimizer
    entry = next(iter(fused._cache.values()))
    real = entry.update.graph
    counts = dict(o._index_update_count)
    errors = []
    entry.update.graph = _FailingGraph()
    try:
        for _ in range(2):
            try:
                fused(*batch, batch_size=batch[-1].shape[0])
                errors.append(None)
            except KernelError as e:
                errors.append(str(e))
    finally:
        entry.update.graph = real
    rolled_back = dict(o._index_update_count) == counts
    guidance = bool(errors[0] and "donated" in errors[0]
                    and errors[1] and "reset" in errors[1])
    run["net"].load_parameters(path)
    fused.reset()
    _dist_counts(zero=True)
    after = [float(fused(*batch, batch_size=batch[-1].shape[0])
                   .mean().asscalar()) for _ in range(2)]
    torch.cuda.synchronize()
    return dict(first_error=errors[0] and errors[0][:160],
                later_error=errors[1] and errors[1][:160],
                guidance=guidance,
                counts_rolled_back=rolled_back, losses_after_reset=after,
                launches_after_reset=_dist_counts(),
                signatures_after_reset=len(fused._cache))


def phase_gluon_fused(torch):
    """``gluon_fused``: ``FusedTrainStep`` against the three-call recipe
    (module comment above ``GLUON_FUSED``).  Returns B1-B3's wrapper
    launches in the fused run and their records in its traced steps."""
    import mxnet_tpu_torch as mx
    cfg = GLUON_FUSED
    ex, ev, ey = _encoder_batch(GLUON_FLASH)
    tmp = tempfile.mkdtemp(prefix="mxnet-gluon-fused-")
    try:
        path = os.path.join(tmp, "encoder.npz")
        _encoder_weights(mx, GLUON_FLASH, path)
        with mx.gpu(0):
            batch = tuple(mx.nd.array(a) for a in (ex, ev, ey))
            runs = _fused_runs(mx, path, batch)
            fnet = runs["fused"]["net"]
            grads0 = [p.grad().asnumpy() for p in
                      fnet.collect_params().values() if p.grad_req != "null"]
            for r in runs.values():
                _dist_counts(zero=True)
                r["losses"], r["first_ms"] = _gluon_loop(
                    r["step"], cfg["steps"], sync=torch.cuda.synchronize)
                r["launches"] = _dist_counts()
            param_err = _gluon_param_err(fnet, runs["three_call"]["net"])
            grads_untouched = all(
                np.array_equal(g, p.grad().asnumpy()) for g, p in zip(
                    grads0, [p for p in fnet.collect_params().values()
                             if p.grad_req != "null"]))
            for r in runs.values():
                _l, ms = _gluon_loop(r["step"], cfg["timed_steps"],
                                     sync=torch.cuda.synchronize)
                r["ms_per_step"] = float(np.median(ms))
            fused = runs["fused"]
            trace = _trace_steps(torch, fused["step"], cfg["traced_steps"],
                                 fused["ms_per_step"], warm=fused["step"],
                                 where="gluon_fused", names=FLASH_NAMES)
            graph_launches = TRACE_LAUNCHES[-1]["counted"]
            entry = next(iter(fused["fused"]._cache.values()))
            replays, capture_s = entry.update.replays, entry.update.capture_s
            del entry
            poison = _fused_poison(torch, mx, fused, path, batch)
            for r in runs.values():
                for k in ("net", "trainer", "fused", "step"):
                    r.pop(k)
        _free(torch)
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    f, t = runs["fused"], runs["three_call"]
    rel = [abs(a - b) / abs(b) for a, b in zip(f["losses"], t["losses"])]
    first_after = abs(poison["losses_after_reset"][0] - f["losses"][0]) \
        / abs(f["losses"][0])
    emit("gluon_fused", layer="bert_24_1024_16 encoder layer + "
         "SoftmaxCrossEntropyLoss in one HybridBlock",
         **{k: GLUON_FLASH[k] for k in ("units", "heads", "ffn", "L", "B",
                                        "lr")},
         optimizer="adam", dtype="float32", steps=cfg["steps"],
         losses=f["losses"], three_call_losses=t["losses"],
         loss_rel_err=rel, losses_bitwise_equal=f["losses"] == t["losses"],
         param_err_of_tol=param_err, grads_untouched=grads_untouched,
         ms_per_step=f["ms_per_step"],
         three_call_ms_per_step=t["ms_per_step"],
         first_step_ms=f["first_ms"][0], launches=f["launches"],
         launches_three_call=t["launches"],
         graph_launches_per_traced_step=len(graph_launches)
         / cfg["traced_steps"], replays=replays, capture_s=capture_s,
         trace=trace, poison=poison,
         first_loss_after_reset_rel_err=first_after,
         loss_rtol=GLUON_HYBRID_LOSS_RTOL,
         first_loss_rtol=GLUON_HYBRID_FIRST_RTOL,
         param_tol=GLUON_HYBRID_PARAM_TOL)
    check(all(np.isfinite(f["losses"])), f"gluon_fused: losses {f['losses']}")
    check(rel[0] <= GLUON_HYBRID_FIRST_RTOL
          and max(rel) <= GLUON_HYBRID_LOSS_RTOL,
          f"gluon_fused: losses {rel} from the three-call recipe")
    check(param_err <= 1.0, f"gluon_fused: parameters {param_err} of "
                            f"{GLUON_HYBRID_PARAM_TOL} from the recipe")
    check(grads_untouched, "gluon_fused: FusedTrainStep wrote .grad")
    check(f["launches"] == dict.fromkeys(FLASH_NAMES, 1),
          f"gluon_fused: B1-B3 wrapper launches {f['launches']}, want 1 "
          f"each (the first, eager step)")
    check(trace["records_per_step"] == dict.fromkeys(FLASH_NAMES, 1.0)
          and len(graph_launches) == cfg["traced_steps"],
          f"gluon_fused: {trace['records_per_step']} B1-B3 records and "
          f"{graph_launches} graph launches in {cfg['traced_steps']} steps")
    check(poison["guidance"] and poison["counts_rolled_back"]
          and all(np.isfinite(poison["losses_after_reset"]))
          and first_after <= GLUON_HYBRID_FIRST_RTOL
          and poison["launches_after_reset"]
          == dict.fromkeys(FLASH_NAMES, 1),
          f"gluon_fused: the injected failure {poison}")
    return dict(launches=f["launches"],
                traced={k: v * cfg["traced_steps"]
                        for k, v in trace["records_per_step"].items()})


# --------------------------------------------------------------- gluon_moe
# One encoder layer at Switch-Base-8's published widths (Fedus et al.
# 2021; google/switch-base-8 config.json: d_model 768, num_heads 12,
# d_ff 3072, num_experts 8, relu; router capacity factor 1.25 in
# training, aux loss weight 0.01): qkv -> F.flash_selfatt -> proj,
# residual + LayerNorm, gluon.contrib.MoEFFN, residual + LayerNorm, a
# two-way head on position 0 with SoftmaxCrossEntropyLoss + 0.01 x the
# Switch aux loss.  One layer at those widths, not the T5 model.  Batch 8
# x L 512 (4096 tokens: capacity 640 a expert), fp32 with TF32 off, Adam
# at lr 1e-4, trained by FusedTrainStep (one CUDA graph a step) against
# the three-call recipe from the same weights (GLUON_FUSED's bounds), the
# first step at batch 2 against the same FusedTrainStep on the host, and
# the router's expert choices on the card against the host's.
SWITCH = dict(units=768, heads=12, ffn=3072, experts=8,
              capacity_factor=1.25, aux_weight=0.01, L=512, B=8,
              host_B=2, dist_B=2, steps=3, timed_steps=10, traced_steps=3,
              lr=1e-4, optimizer_replays=10,
              valid=(377, 280, 179, 450, 112, 92, 230, 64))
# the first step's loss, card vs host at batch 2 (GLUON_FLASH's bound:
# the attention's and the experts' sums in another order)
SWITCH_HOST_RTOL = 1e-4


def _switch_layer(mx):
    """The Switch-Base-8-width encoder layer (comment above ``SWITCH``):
    ``layer(x, valid_length) -> (logits, aux_loss)``; ``moe_input`` is
    the tokens the MoE layer routes."""
    from mxnet_tpu_torch.gluon.contrib import MoEFFN
    nn, cfg = mx.gluon.nn, SWITCH
    units, heads = cfg["units"], cfg["heads"]

    class SwitchLayer(mx.gluon.HybridBlock):
        def __init__(self, **kw):
            super().__init__(**kw)
            with self.name_scope():
                self.qkv = nn.Dense(3 * units, flatten=False,
                                    in_units=units)
                self.proj = nn.Dense(units, flatten=False, in_units=units)
                self.ln1 = nn.LayerNorm(in_channels=units)
                self.moe = MoEFFN(units, cfg["ffn"], cfg["experts"],
                                  capacity_factor=cfg["capacity_factor"],
                                  activation="relu")
                self.ln2 = nn.LayerNorm(in_channels=units)
                self.head = nn.Dense(2, in_units=units)

        def _attend(self, F, x, valid_length):
            att = F.flash_selfatt(self.qkv(x), valid_length, heads=heads)
            return self.ln1(x + self.proj(att))

        def moe_input(self, x, valid_length):
            return self._attend(mx.nd, x, valid_length)

        def hybrid_forward(self, F, x, valid_length):
            h = self._attend(F, x, valid_length)
            m, aux = self.moe(h)
            h = self.ln2(h + m)
            return (self.head(F.squeeze(F.slice_axis(h, axis=0, begin=0,
                                                     end=1), axis=0)),
                    aux)

    return SwitchLayer()


def _switch_loss_block(mx, inner):
    """The layer and its loss as one HybridBlock: ``block(x,
    valid_length, label)`` is each example's cross entropy plus
    ``aux_weight`` x the aux loss."""

    class WithLoss(mx.gluon.HybridBlock):
        def __init__(self, **kw):
            super().__init__(**kw)
            with self.name_scope():
                self.inner = inner
                self.loss = mx.gluon.loss.SoftmaxCrossEntropyLoss()

        def hybrid_forward(self, F, x, valid_length, label):
            logits, aux = self.inner(x, valid_length)
            return self.loss(logits, label) + SWITCH["aux_weight"] * aux

    return WithLoss()


def _switch_batch(B, seed):
    return _encoder_batch(dict(L=SWITCH["L"], B=B, units=SWITCH["units"],
                               valid=SWITCH["valid"]), seed=seed)


def _switch_weights(mx, path):
    """The layer's weights from seed 0 (Xavier, drawn on the host),
    saved."""
    mx.random.seed(0)
    with mx.cpu(0):
        net = _switch_layer(mx)
        net.initialize(mx.init.Xavier())
        net.save_parameters(path)


def _switch_routing(torch, mx, net, x, valid):
    """The MoE layer's routing of the batch's tokens under the layer's
    weights, by the port's routing op (``ops.moe.moe_top1_dispatch``: the
    ``_route`` and ``_dispatch`` that ``moe_ffn`` runs) over the gates'
    logits: each token's expert, its top-1 minus top-2 gate, the tokens
    each expert is chosen by, and the tokens dropped past the capacity
    (routed, given no slot).  A pass of its own, outside the step."""
    from mxnet_tpu_torch.ops.moe import moe_top1_dispatch
    with mx.autograd.pause(), torch.no_grad():
        h = net.moe_input(mx.nd.array(x), mx.nd.array(valid))._data
        hs = h.reshape(-1, h.shape[-1]).float()
        logits = hs @ net.moe.gate_weight.data()._data.float()
        _c, dispatch, _aux = moe_top1_dispatch(
            logits, capacity_factor=SWITCH["capacity_factor"])
        gates = torch.softmax(logits, -1)
    top = torch.topk(gates, 2, dim=-1).values
    expert = torch.argmax(gates, dim=-1)
    return dict(expert=expert.cpu().numpy(),
                margin=(top[:, 0] - top[:, 1]).cpu().numpy(),
                counts=torch.bincount(expert, minlength=gates.shape[1])
                .tolist(), capacity=int(dispatch.shape[-1]),
                dropped=int(hs.shape[0] - dispatch.sum()))


def _switch_run(mx, path, batch, mode):
    """The layer from ``path`` with its loss: ``FusedTrainStep`` or the
    three-call recipe over ``batch`` (NDArrays)."""
    from mxnet_tpu_torch.gluon.contrib import FusedTrainStep
    net = _switch_layer(mx)
    net.load_parameters(path)
    trainer = mx.gluon.Trainer(net.collect_params(), "adam",
                               {"learning_rate": SWITCH["lr"]})
    block = _switch_loss_block(mx, net)
    if mode == "fused":
        fused = FusedTrainStep(block, trainer)
        return dict(net=net, trainer=trainer, fused=fused,
                    step=functools.partial(fused, *batch,
                                           batch_size=batch[-1].shape[0]))
    block.hybridize()
    return dict(net=net, trainer=trainer,
                step=_gluon_stepper(mx, trainer, batch, block=block))


def _switch_host_check(torch, mx, path):
    """The first FusedTrainStep step at batch 2, card and host, from the
    same weights: both losses, and the router's choices token by token
    (those that differ with their gate margins)."""
    x, v, y = _switch_batch(SWITCH["host_B"], seed=2)
    out = {}
    for name, ctx in (("card", mx.gpu(0)), ("host", mx.cpu(0))):
        with ctx:
            batch = tuple(mx.nd.array(a) for a in (x, v, y))
            run = _switch_run(mx, path, batch, "fused")
            routing = _switch_routing(torch, mx, run["net"], x, v)
            loss = float(run["step"]().mean().asscalar())
            out[name] = dict(loss=loss, routing=routing)
            del run
    card, host = out["card"]["routing"], out["host"]["routing"]
    differ = np.flatnonzero(card["expert"] != host["expert"])
    return dict(
        card_loss=out["card"]["loss"], host_loss=out["host"]["loss"],
        loss_rel_err=abs(out["card"]["loss"] - out["host"]["loss"])
        / abs(out["host"]["loss"]),
        tokens=int(card["expert"].size), experts_agree=not differ.size,
        differing_tokens=[dict(token=int(t), card=int(card["expert"][t]),
                               host=int(host["expert"][t]),
                               host_margin=float(host["margin"][t]))
                          for t in differ[:16]],
        smallest_margin=float(host["margin"].min()),
        card_counts=card["counts"], host_counts=host["counts"])


def phase_gluon_moe(torch):
    """``gluon_moe``: the Switch-Base-8-width layer (module comment above
    ``SWITCH``) trained by ``FusedTrainStep`` at batch 8 x L 512.
    Returns B1-B3's wrapper launches in the fused run and their records
    in its traced steps."""
    import mxnet_tpu_torch as mx
    cfg = SWITCH
    x, v, y = _switch_batch(cfg["B"], seed=1)
    tmp = tempfile.mkdtemp(prefix="mxnet-gluon-moe-")
    try:
        path = os.path.join(tmp, "switch.npz")
        _switch_weights(mx, path)
        host = _switch_host_check(torch, mx, path)
        _free(torch)
        with mx.gpu(0):
            batch = tuple(mx.nd.array(a) for a in (x, v, y))
            runs = {m: _switch_run(mx, path, batch, m)
                    for m in ("fused", "three_call")}
            fused = runs["fused"]

            def keep(i):
                # each step's weights, for the routing pass below (a copy
                # to the host: nothing of the path launches)
                if i + 1 < cfg["steps"]:
                    fused["net"].save_parameters(
                        os.path.join(tmp, f"step{i + 1}.npz"))

            for mode, r in runs.items():
                _dist_counts(zero=True)
                r["losses"], r["first_ms"] = _gluon_loop(
                    r["step"], cfg["steps"], sync=torch.cuda.synchronize,
                    on_step=keep if mode == "fused" else None)
                r["launches"] = _dist_counts()
            param_err = _gluon_param_err(fused["net"],
                                         runs["three_call"]["net"])
            routing = _switch_routing(torch, mx, fused["net"], x, v)
            # the tokens each counted step dropped, from the weights it
            # started from
            rnet = _switch_layer(mx)
            dropped = []
            for i in range(cfg["steps"]):
                rnet.load_parameters(
                    path if i == 0 else os.path.join(tmp, f"step{i}.npz"))
                dropped.append(_switch_routing(torch, mx, rnet, x,
                                               v)["dropped"])
            del rnet
            for r in runs.values():
                _l, ms = _gluon_loop(r["step"], cfg["timed_steps"],
                                     sync=torch.cuda.synchronize)
                r["ms_per_step"] = float(np.median(ms))
            # the optimizer's kernels: the sequence one replay of the
            # Trainer's own update graph over the same parameters runs
            # (their .grad buffers: FusedTrainStep leaves them untouched),
            # found again at the end of each traced FusedTrainStep replay
            opt_step = functools.partial(fused["trainer"].step, cfg["B"])
            with _profiled(torch, warm=lambda: [opt_step(), opt_step()],
                           where="gluon_moe optimizer") as prof:
                for _ in range(cfg["traced_steps"]):
                    opt_step()
            opt_seq = [n for n, _us in _kernel_sequence(torch, prof)]
            k = len(opt_seq) // cfg["traced_steps"]
            tail = opt_seq[:k] if opt_seq == opt_seq[:k] \
                * cfg["traced_steps"] else None
            optimizer_alone_ms = Timer(torch, torch.device("cuda:0"))(
                opt_step, iters=cfg["optimizer_replays"])
            trace = _trace_steps(torch, fused["step"], cfg["traced_steps"],
                                 fused["ms_per_step"], warm=fused["step"],
                                 where="gluon_moe", names=FLASH_NAMES,
                                 tail=tail)
            graph_launches = TRACE_LAUNCHES[-1]["counted"]
            n_params = sum(int(np.prod(p.shape)) for p in
                           fused["net"].collect_params().values())
            for r in runs.values():
                for k in ("net", "trainer", "fused", "step"):
                    r.pop(k, None)
        _free(torch)
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    f, t = runs["fused"], runs["three_call"]
    rel = [abs(a - b) / abs(b) for a, b in zip(f["losses"], t["losses"])]
    fam = trace["device_ms_per_step_by_family"] or {}
    attention = sum(trace["device_ms_per_step_by_name"].values())
    device = trace["device_ms_per_step"] or 0.0
    # one trace's split: the optimizer is its kernels' runs inside the
    # traced replays, one a replay, or not given
    optimizer = trace.get("tail_device_ms_per_step") \
        if trace.get("tail_runs") == cfg["traced_steps"] else None
    split = dict(einsums_gemm=fam.get("gemm"), attention_b1_b3=attention,
                 optimizer=optimizer,
                 other=None if optimizer is None
                 else device - (fam.get("gemm") or 0.0) - attention
                 - optimizer)
    emit("gluon_moe", layer="Switch-Base-8 widths (google/switch-base-8): "
         "flash attention + MoEFFN, one encoder layer",
         **{k: cfg[k] for k in ("units", "heads", "ffn", "experts",
                                "capacity_factor", "L", "B", "lr")},
         tokens=cfg["L"] * cfg["B"], capacity=routing["capacity"],
         optimizer="adam", dtype="float32", parameters=n_params,
         path="FusedTrainStep: one CUDA graph a step",
         losses=f["losses"], three_call_losses=t["losses"],
         loss_rel_err=rel, param_err_of_tol=param_err,
         tokens_dropped_per_step=dropped,
         tokens_dropped_from="ops.moe.moe_top1_dispatch over each counted "
         "step's starting weights, a pass outside the step",
         expert_counts_after=routing["counts"],
         ms_per_step=f["ms_per_step"],
         three_call_ms_per_step=t["ms_per_step"],
         first_step_ms=f["first_ms"][0], device_ms_split=split,
         optimizer_kernels_a_replay=len(tail or ()),
         optimizer_runs_found=trace.get("tail_runs"),
         optimizer_alone_ms=optimizer_alone_ms,
         launches=f["launches"], launches_three_call=t["launches"],
         graph_launches_per_traced_step=len(graph_launches)
         / cfg["traced_steps"], trace=trace, host_check=host,
         loss_rtol=GLUON_HYBRID_LOSS_RTOL, param_tol=GLUON_HYBRID_PARAM_TOL,
         host_rtol=SWITCH_HOST_RTOL)
    check(all(np.isfinite(f["losses"])), f"gluon_moe: losses {f['losses']}")
    check(rel[0] <= GLUON_HYBRID_FIRST_RTOL
          and max(rel) <= GLUON_HYBRID_LOSS_RTOL and param_err <= 1.0,
          f"gluon_moe: losses {rel}, parameters {param_err} of tolerance "
          f"from the three-call recipe")
    check(host["loss_rel_err"] <= SWITCH_HOST_RTOL,
          f"gluon_moe: the first loss at batch 2 on the card "
          f"{host['card_loss']} vs the host {host['host_loss']}")
    check(f["launches"] == dict.fromkeys(FLASH_NAMES, 1),
          f"gluon_moe: B1-B3 wrapper launches {f['launches']}, want 1 each")
    check(trace["records_per_step"] == dict.fromkeys(FLASH_NAMES, 1.0)
          and len(graph_launches) == cfg["traced_steps"],
          f"gluon_moe: {trace['records_per_step']} B1-B3 records and "
          f"{graph_launches} graph launches in {cfg['traced_steps']} steps")
    return dict(launches=f["launches"],
                traced={k: v * cfg["traced_steps"]
                        for k, v in trace["records_per_step"].items()})


# ------------------------------------------------------------- faster_rcnn
# examples/faster_rcnn.py's recipe at its own sizes: 128x128 images,
# batch 8, FPN channels 32, rpn_pre_topk 64, rpn_post_topk 16, Adam at
# lr 5e-4, 120 iterations of the eager record / backward / step loop over
# 256 one-rectangle images from seed 0 (the example's synth_rec drawn
# straight into arrays: no JPEG round trip, which waits for the io /
# image slice; reshuffled every epoch as ImageRecordIter(shuffle=True)
# does), then the held-out top-detection recall over 64 images from
# seed 1, held to the example's --min-recall 0.5.  The first iteration's
# RPN loss against the host's from the same weights and batch, and its
# ROI loss against the host's over the card's proposals (proposals are a
# top-k: near-equal scores may order otherwise; whether they agree is
# reported).
FASTER_RCNN = dict(img=128, batch=8, channels=32, pre=64, post=16, lr=5e-4,
                   iters=120, train_images=256, eval_images=64,
                   min_recall=0.5)
FASTER_RCNN_COLORS = {1: (200, 60, 40), 2: (40, 200, 60)}
FASTER_RCNN_HOST_RTOL = 1e-4


def _frcnn_images(n, seed):
    """``synth_rec`` of examples/faster_rcnn.py into arrays: images (n, 3,
    IMG, IMG) scaled to [0, 1] and labels (n, 5) [cls, x0, y0, x1, y1] in
    pixels, from the same draws."""
    img = FASTER_RCNN["img"]
    rng = np.random.RandomState(seed)
    imgs = np.zeros((n, 3, img, img), np.float32)
    labels = np.zeros((n, 5), np.float32)
    for i in range(n):
        cls = rng.randint(1, 3)
        w = rng.randint(28, 72)
        h = rng.randint(28, 72)
        x0 = rng.randint(4, img - w - 4)
        y0 = rng.randint(4, img - h - 4)
        pic = rng.randint(0, 60, (img, img, 3)).astype(np.uint8)
        pic[y0:y0 + h, x0:x0 + w] = np.array(
            FASTER_RCNN_COLORS[cls], np.uint8) + rng.randint(
                -20, 20, 3).astype(np.int16).astype(np.uint8)
        imgs[i] = pic.transpose(2, 0, 1) / 255.0
        labels[i] = [cls, x0, y0, x0 + w, y0 + h]
    return imgs, labels


def _frcnn_net(mx):
    """The example's backbone and ``FasterRCNN`` on the port."""
    from mxnet_tpu_torch.gluon.contrib import detection as det
    nn, cfg = mx.gluon.nn, FASTER_RCNN

    class Feats(mx.gluon.HybridBlock):
        def __init__(self, **kw):
            super().__init__(**kw)
            with self.name_scope():
                self.s1 = nn.HybridSequential()
                for _ in range(3):
                    self.s1.add(nn.Conv2D(32, 3, strides=2, padding=1,
                                          activation="relu"))
                self.s2 = nn.Conv2D(48, 3, strides=2, padding=1,
                                    activation="relu")
                self.s3 = nn.Conv2D(64, 3, strides=2, padding=1,
                                    activation="relu")

        def hybrid_forward(self, F, x):
            c3 = self.s1(x)
            c4 = self.s2(c3)
            c5 = self.s3(c4)
            return c3, c4, c5

    return det.FasterRCNN(Feats(), (32, 48, 64), num_classes=2,
                          image_size=(cfg["img"], cfg["img"]),
                          channels=cfg["channels"],
                          rpn_pre_topk=cfg["pre"],
                          rpn_post_topk=cfg["post"])


def _frcnn_step(mx, net, trainer, x, lab):
    """One iteration of the example's loop: (loss, rpn loss, roi loss,
    the proposals and their keep mask)."""
    nd = mx.nd
    gt_b = nd.array(lab[:, None, 1:5])
    gtc_b = nd.array(lab[:, None, 0].astype(np.int32), dtype="int32")
    with mx.autograd.record():
        levels, anchors, obj, reg = net.rpn_forward(x)
        rloss = net.rpn_loss(anchors, obj, reg, gt_b)
        rois_b, _sc, keep_b = net.proposals(anchors, obj, reg)
        closs = net.rcnn_loss(levels, rois_b, gt_b, gtc_b, keep=keep_b)
        loss = rloss + closs
    loss.backward()
    trainer.step(x.shape[0])
    return loss, rloss, closs, rois_b, keep_b


def _frcnn_trainer(mx, net):
    params = {k: p for k, p in net.collect_params().items()
              if p.grad_req != "null"}
    return mx.gluon.Trainer(params, "adam",
                            {"learning_rate": FASTER_RCNN["lr"]})


def _frcnn_recall(mx, net, imgs, labels):
    """The example's ``evaluate``: the share of images whose top
    detection has IoU >= 0.5 with the ground truth and its class."""
    hits = 0
    bs = FASTER_RCNN["batch"]
    for s in range(0, len(imgs), bs):
        cls, boxes, rscores = net(mx.nd.array(imgs[s:s + bs]))
        prob = mx.nd.softmax(cls, axis=-1).asnumpy()
        boxes, rs = boxes.asnumpy(), rscores.asnumpy()
        for b, lab in enumerate(labels[s:s + bs]):
            fg = np.where(np.isfinite(rs[b])[:, None], prob[b, :, 1:], 0.0)
            r, c = np.unravel_index(np.argmax(fg), fg.shape)
            pb, gb = boxes[b, r, c], lab[1:5]
            ix = max(0.0, min(pb[2], gb[2]) - max(pb[0], gb[0]))
            iy = max(0.0, min(pb[3], gb[3]) - max(pb[1], gb[1]))
            inter = ix * iy
            union = ((pb[2] - pb[0]) * (pb[3] - pb[1])
                     + (gb[2] - gb[0]) * (gb[3] - gb[1]) - inter)
            hits += (c + 1 == int(lab[0])
                     and inter / max(union, 1e-9) >= 0.5)
    return hits / len(imgs)


def phase_faster_rcnn(torch):
    """``faster_rcnn``: examples/faster_rcnn.py's loop and held-out recall
    on the card (module comment above ``FASTER_RCNN``)."""
    import mxnet_tpu_torch as mx
    cfg = FASTER_RCNN
    imgs, labels = _frcnn_images(cfg["train_images"], seed=0)
    eval_imgs, eval_labels = _frcnn_images(cfg["eval_images"], seed=1)
    order = np.random.RandomState(0)
    batches, per_epoch = [], cfg["train_images"] // cfg["batch"]
    while len(batches) < cfg["iters"]:
        perm = order.permutation(cfg["train_images"])
        batches += [perm[i * cfg["batch"]:(i + 1) * cfg["batch"]]
                    for i in range(per_epoch)]
    batches = batches[:cfg["iters"]]
    tmp = tempfile.mkdtemp(prefix="mxnet-frcnn-")
    try:
        path = os.path.join(tmp, "frcnn.npz")
        mx.random.seed(0)
        with mx.cpu(0):
            init = _frcnn_net(mx)
            init.initialize(mx.init.Xavier())
            init(mx.nd.zeros((1, 3, cfg["img"], cfg["img"])))
            init.save_parameters(path)
        with mx.gpu(0):
            net = _frcnn_net(mx)
            net.load_parameters(path)
            trainer = _frcnn_trainer(mx, net)
            losses, first = [], None
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            for i, idx in enumerate(batches):
                loss, rloss, closs, rois, keep = _frcnn_step(
                    mx, net, trainer, mx.nd.array(imgs[idx]), labels[idx])
                losses.append(loss)
                if i == 0:
                    first = dict(rpn=float(rloss.asscalar()),
                                 roi=float(closs.asscalar()),
                                 rois=rois.cpu().numpy(),
                                 keep=keep.cpu().numpy())
            torch.cuda.synchronize()
            train_s = time.perf_counter() - t0
            losses = [float(v.asscalar()) for v in losses]
            t0 = time.perf_counter()
            recall = _frcnn_recall(mx, net, eval_imgs, eval_labels)
            eval_s = time.perf_counter() - t0
            devices = sorted({str(p.data().data_torch.device)
                              for p in net.collect_params().values()})
            del net, trainer
        with mx.cpu(0):
            host = _frcnn_net(mx)
            host.load_parameters(path)
            idx = batches[0]
            x, lab = mx.nd.array(imgs[idx]), labels[idx]
            gt_b = mx.nd.array(lab[:, None, 1:5])
            gtc_b = mx.nd.array(lab[:, None, 0].astype(np.int32),
                                dtype="int32")
            levels, anchors, obj, reg = host.rpn_forward(x)
            h_rpn = float(host.rpn_loss(anchors, obj, reg, gt_b).asscalar())
            h_rois, _s, h_keep = host.proposals(anchors, obj, reg)
            h_roi = float(host.rcnn_loss(
                levels, first["rois"], gt_b, gtc_b,
                keep=first["keep"]).asscalar())
            same_keep = bool(np.array_equal(h_keep.numpy(), first["keep"]))
            rois_err = float(np.abs(np.where(
                first["keep"][..., None], h_rois.numpy() - first["rois"],
                0.0)).max()) if same_keep else None
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    _free(torch)
    rpn_rel = abs(first["rpn"] - h_rpn) / abs(h_rpn)
    roi_rel = abs(first["roi"] - h_roi) / abs(h_roi)
    head, tail = float(np.mean(losses[:10])), float(np.mean(losses[-10:]))
    emit("faster_rcnn", example="examples/faster_rcnn.py",
         data="synth_rec drawn into arrays (no JPEG)",
         **{k: cfg[k] for k in ("img", "batch", "channels", "pre", "post",
                                "lr", "iters", "train_images",
                                "eval_images")},
         optimizer="adam", dtype="float32", devices=devices,
         train_seconds=train_s, iter_ms=train_s / cfg["iters"] * 1e3,
         eval_seconds=eval_s, recall=recall, min_recall=cfg["min_recall"],
         first_losses=losses[:5], last_losses=losses[-5:],
         mean_loss_first10=head, mean_loss_last10=tail,
         first_iter=dict(rpn=first["rpn"], roi=first["roi"],
                         host_rpn=h_rpn, host_roi_on_card_proposals=h_roi,
                         rpn_rel_err=rpn_rel, roi_rel_err=roi_rel,
                         proposals_keep_agree=same_keep,
                         kept_proposals_max_abs_err=rois_err),
         host_rtol=FASTER_RCNN_HOST_RTOL)
    check(all(d.startswith("cuda") for d in devices),
          f"faster_rcnn: weights on {devices}")
    check(all(np.isfinite(losses)) and tail < head,
          f"faster_rcnn: losses {head} -> {tail}")
    check(rpn_rel <= FASTER_RCNN_HOST_RTOL
          and roi_rel <= FASTER_RCNN_HOST_RTOL,
          f"faster_rcnn: first iteration's losses vs the host: rpn "
          f"{rpn_rel}, roi {roi_rel}")
    check(recall >= cfg["min_recall"],
          f"faster_rcnn: held-out recall {recall} below "
          f"{cfg['min_recall']}")


# ---------------------------------------------------------------- symbolic
# The symbolic API of mxnet_tpu_torch (Symbol, shape inference, Executor,
# Module, BucketingModule, SymbolBlock), fp32 with TF32 off:
# - examples/lenet_symbol.py's Module.fit at its settings (2048 samples
#   of 64 features from RandomState(0), batch 128, shuffled, 5 epochs,
#   SGD lr 0.1, mx.random.seed(0)), its initial weights drawn by the
#   module's default initializer on the host so that the card's first
#   batches can be held against the same loop on the host (numpy's
#   shuffle seeded 0 for both);
# - gluon_flash's encoder layer at BERT-large widths composed over Symbol
#   inputs data and valid_length, SoftmaxOutput on its head, trained 5
#   SGD steps through Module (B1 inside the Executor's forward graph, B2
#   and B3 inside its backward graph), against the layer's eager Gluon
#   step on the card and the same Module on the host;
# - HybridBlock.export / SymbolBlock.imports of gluon_mnist's LeNet, the
#   layer's symbol as a hybridized SymbolBlock over the layer's own
#   parameters, and the JAX package's symbol file of
#   tests/test_torch_symbol.py's fixture graph on the card and the host;
# - a BucketingModule of the layer over L 128 / 256 / 512.
SYMBOLIC_LENET = dict(n=2048, features=64, classes=10, batch=128, epochs=5,
                      lr=0.1, host_batches=3)
# examples/lenet_symbol.py through the JAX package on the CPU reaches
# accuracy 1.0 (its final score); the card must reach that less 0.02
SYMBOLIC_LENET_MIN_ACCURACY = 1.0 - 0.02
SYMBOLIC_ENCODER = dict(steps=5, lr=0.01, traced_steps=3)
# Module.fit(monitor=Monitor(interval, pattern)) on the card's LeNet run:
# the weights, their gradients and the output statted every interval-th
# batch; a monitored hybridized Gluon LeNet (gluon_mnist's, batch 64,
# Adam) launches as many graphs a step as the unmonitored one
SYMBOLIC_MONITOR = dict(interval=16, pattern=r".*weight(_grad)?$|output0",
                        batch=64, steps=6, traced_steps=3)
SYMBOLIC_BUCKETS = (128, 256, 512)
SYMBOLIC_BUCKET_STEPS = 2
# a SymbolBlock against the block it came from: the same kernels on the
# same inputs (of the output's max)
SYMBOLIC_BLOCK_TOL = 1e-6
SYMBOLIC_FIXTURE = os.path.join("tests", "fixtures", "jax_symbol_graph.json")
SYMBOLIC_FIXTURE_SHAPES = dict(data=(16, 2, 32), valid_length=(2,),
                               image=(2, 3, 8, 8))


def _lenet_symbol(mx):
    """``examples/lenet_symbol.py``'s ``build_symbol``."""
    sym = mx.sym
    data = sym.var("data")
    h = sym.FullyConnected(data, sym.var("fc1_weight"), sym.var("fc1_bias"),
                           num_hidden=128, name="fc1")
    h = sym.Activation(h, act_type="relu")
    h = sym.FullyConnected(h, sym.var("fc2_weight"), sym.var("fc2_bias"),
                           num_hidden=10, name="fc2")
    return sym.SoftmaxOutput(h, sym.var("softmax_label"), name="softmax")


def _lenet_symbol_data():
    cfg = SYMBOLIC_LENET
    rng = np.random.RandomState(0)
    centers = rng.randn(cfg["classes"], cfg["features"]).astype(
        np.float32) * 3
    labels = rng.randint(0, cfg["classes"], cfg["n"])
    data = centers[labels] + rng.randn(cfg["n"], cfg["features"]).astype(
        np.float32)
    return data, labels.astype(np.float32)


def _lenet_symbol_fit(torch, mx, where, epochs, arg_params=None,
                      monitor=None):
    """``examples/lenet_symbol.py``'s ``main`` on ``where`` (its weights
    ``arg_params`` when given; ``fit(monitor=monitor)``): the module, the
    first batches' outputs, ms a batch, seconds an epoch, programs after
    the first batch, the final score."""
    from mxnet_tpu_torch.module import Module
    cfg = SYMBOLIC_LENET
    data, labels = _lenet_symbol_data()
    on_card = where.device_type == "gpu"
    sync = torch.cuda.synchronize if on_card else (lambda: None)
    outs, stamps, epoch_s, programs = [], [], [], []
    mx.random.seed(0)
    np.random.seed(0)
    with where:
        it = mx.io.NDArrayIter(
            data={"data": mx.nd.array(data)},
            label={"softmax_label": mx.nd.array(labels)},
            batch_size=cfg["batch"], shuffle=True)
        mod = Module(_lenet_symbol(mx), data_names=("data",),
                     label_names=("softmax_label",))
        init = {}
        if arg_params is None:
            mod.bind(data_shapes=it.provide_data,
                     label_shapes=it.provide_label)
            mod.init_params()
            init = {k: v.asnumpy() for k, v in mod.get_params()[0].items()}

        def on_batch(param):
            sync()
            stamps.append(time.perf_counter())
            m = param.locals["self"]
            if len(outs) < cfg["host_batches"]:
                outs.append(m.get_outputs()[0].asnumpy())
            if not programs:
                programs.append(m.num_compiles)

        def on_epoch(epoch, *_args):
            epoch_s.append(time.perf_counter())

        stamps.append(time.perf_counter())
        t0 = stamps[0]
        mod.fit(it, num_epoch=epochs, optimizer="sgd",
                optimizer_params={"learning_rate": cfg["lr"]},
                eval_metric="acc", batch_end_callback=on_batch,
                epoch_end_callback=on_epoch, monitor=monitor,
                arg_params=None if arg_params is None else {
                    k: mx.nd.array(v) for k, v in arg_params.items()})
        score = mod.score(it, mx.metric.Accuracy())
    ms = np.diff(stamps) * 1e3
    return dict(module=mod, init=init, outs=outs, ms=ms,
                epoch_s=list(np.diff([t0] + epoch_s)),
                programs_after_first_batch=programs[0],
                programs_after_score=mod.num_compiles,
                accuracy=dict(score)["accuracy"],
                device=str(mod._exec.arg_dict["fc1_weight"]._data.device))


def _symbol_monitor(mx):
    """The card run's ``Monitor`` and the list its ``toc_print`` results
    go to."""
    mon = mx.monitor.Monitor(interval=SYMBOLIC_MONITOR["interval"],
                             pattern=SYMBOLIC_MONITOR["pattern"])
    seen, real = [], mon.toc_print

    def toc_print():
        res = real()
        seen.append(res)
        return res

    mon.toc_print = toc_print
    return mon, seen


def _monitor_summary(seen, batches):
    """Which batches were statted, with which names; whether every stat
    is finite."""
    statted = [i for i, res in enumerate(seen) if res]
    names = sorted({n for res in seen for _s, n, _v in res})
    finite = all(isinstance(v, float) and np.isfinite(v)
                 for res in seen for _s, _n, v in res)
    want = [i for i in range(batches)
            if i % SYMBOLIC_MONITOR["interval"] == 0]
    return dict(interval=SYMBOLIC_MONITOR["interval"], statted=statted,
                want=want, names=names, finite=finite,
                calls=len(seen))


def _phase_lenet_symbol(torch, mx):
    cfg = SYMBOLIC_LENET
    host = _lenet_symbol_fit(torch, mx, mx.cpu(0), 1)
    mon, seen = _symbol_monitor(mx)
    card = _lenet_symbol_fit(torch, mx, mx.gpu(0), cfg["epochs"],
                             arg_params=host["init"], monitor=mon)
    monitored = _monitor_summary(seen, len(card["ms"]))
    rel = [float(np.abs(a - b).max() / np.abs(b).max())
           for a, b in zip(card["outs"], host["outs"])]
    steps = len(card["ms"])
    out = dict(model="examples/lenet_symbol.py (Module.fit)",
               samples=cfg["n"], batch=cfg["batch"], epochs=cfg["epochs"],
               optimizer="sgd", lr=cfg["lr"], device=card["device"],
               first_batches_rel_err=rel, rtol=GLUON_LENET_RTOL,
               accuracy=card["accuracy"],
               min_accuracy=SYMBOLIC_LENET_MIN_ACCURACY,
               ms_per_batch=float(np.median(card["ms"][1:])),
               first_batch_ms=float(card["ms"][0]), batches=steps,
               epoch_s=card["epoch_s"],
               host_ms_per_batch=float(np.median(host["ms"][1:])),
               programs_after_first_batch=card["programs_after_first_batch"],
               programs_after_score=card["programs_after_score"],
               capture_s={str(k): p.capture_s for k, p in
                          card["module"]._exec._programs.items()},
               monitor=monitored)
    check(card["device"].startswith("cuda"),
          f"symbolic lenet: trained on {card['device']}")
    check(monitored["statted"] == monitored["want"]
          and monitored["calls"] == len(card["ms"]) and monitored["finite"]
          and {"fc1_weight", "fc1_weight_grad", "fc2_weight",
               "fc2_weight_grad"} <= set(monitored["names"]),
          f"symbolic lenet: the monitor's stats {monitored}")
    check(all(e <= t for e, t in zip(rel, GLUON_LENET_RTOL))
          and len(rel) == cfg["host_batches"],
          f"symbolic lenet: first batches vs the host {rel}")
    check(card["accuracy"] >= SYMBOLIC_LENET_MIN_ACCURACY,
          f"symbolic lenet: accuracy {card['accuracy']}")
    check(card["programs_after_first_batch"] == 2
          and card["programs_after_score"] == 3,
          f"symbolic lenet: programs {card['programs_after_first_batch']} "
          f"after the first batch, {card['programs_after_score']} after "
          f"score")
    return out


def _encoder_symbol(mx, net, head=True):
    """The layer composed over Symbol inputs (with SoftmaxOutput on its
    head when ``head``)."""
    out = net(mx.sym.var("data"), mx.sym.var("valid_length"))
    if head:
        out = mx.sym.SoftmaxOutput(out, mx.sym.var("softmax_label"),
                                   name="softmax")
    return out


def _encoder_module(mx, net, where, L=None, sym=None):
    """A Module over the layer's symbol, bound for (L, B) on ``where``,
    the layer's values set into it, SGD."""
    from mxnet_tpu_torch.module import Module
    cfg = GLUON_FLASH
    L = L or cfg["L"]
    mod = Module(sym or _encoder_symbol(mx, net),
                 data_names=("data", "valid_length"),
                 label_names=("softmax_label",), context=where)
    mod.bind(data_shapes=[("data", (L, cfg["B"], cfg["units"])),
                          ("valid_length", (cfg["B"],))],
             label_shapes=[("softmax_label", (cfg["B"],))])
    mod.set_params({p.name: p.data() for p in
                    net.collect_params().values()}, {})
    mod.init_optimizer(optimizer="sgd",
                       optimizer_params={"learning_rate":
                                         SYMBOLIC_ENCODER["lr"]})
    return mod


def _encoder_batch_nd(mx, x, valid, y, L=None):
    L = L or GLUON_FLASH["L"]
    v = np.minimum(valid, L).astype(np.float32)
    b = mx.io.DataBatch(data=[mx.nd.array(x[:L]), mx.nd.array(v)],
                        label=[mx.nd.array(y)])
    b.bucket_key = L
    b.provide_data = [("data", (L,) + x.shape[1:]),
                      ("valid_length", v.shape)]
    b.provide_label = [("softmax_label", y.shape)]
    return b


def _module_steps(torch, mod, batch, steps, sync, grad_name=None):
    """``steps`` forward_backward + update: outputs, ms a step, and the
    first step's gradient of ``grad_name``."""
    outs, ms, grad = [], [], None
    for i in range(steps):
        t0 = time.perf_counter()
        mod.forward_backward(batch)
        if i == 0 and grad_name is not None:
            grad = mod._exec.grad_dict[grad_name].asnumpy()
        mod.update()
        sync()
        ms.append((time.perf_counter() - t0) * 1e3)
        outs.append(mod.get_outputs()[0].asnumpy())
    return outs, ms, grad


def _softmax(z):
    e = np.exp(z - z.max(-1, keepdims=True))
    return e / e.sum(-1, keepdims=True)


def _phase_encoder_module(torch, mx, path, hybrid):
    cfg = GLUON_FLASH
    steps = SYMBOLIC_ENCODER["steps"]
    x, valid, y = _encoder_batch(cfg)
    sync = torch.cuda.synchronize
    with mx.gpu(0):
        net = _encoder_layer(mx, cfg["units"], cfg["heads"], cfg["ffn"])
        net.load_parameters(path)
        # the layer's eager Gluon step on the card
        xs, vs, ys = (mx.nd.array(a) for a in (x, valid, y))
        with mx.autograd.record():
            logits = net(xs, vs)
            loss = mx.gluon.loss.SoftmaxCrossEntropyLoss()(logits, ys)
        loss.backward()
        gluon_prob = _softmax(logits.asnumpy())
        gluon_grad = net.qkv.weight.grad().asnumpy()
        qkv = net.qkv.weight.name
        mod = _encoder_module(mx, net, mx.gpu(0))
        batch = _encoder_batch_nd(mx, x, valid, y)
        _dist_counts(zero=True)
        first_outs, first_ms, grad = _module_steps(torch, mod, batch, 1,
                                                   sync, grad_name=qkv)
        launches = _dist_counts()
        _dist_counts(zero=True)
        outs, ms, _ = _module_steps(torch, mod, batch, steps - 1, sync)
        after = _dist_counts()
        outs, ms = first_outs + outs, first_ms + ms
        programs = mod.num_compiles
        step = functools.partial(_module_steps, torch, mod, batch, 1,
                                 lambda: None)
        trace = _trace_steps(torch, step, SYMBOLIC_ENCODER["traced_steps"],
                             float(np.median(ms[1:])), warm=step,
                             where="symbolic encoder_module",
                             names=FLASH_NAMES)
        capture_s = {str(k): p.capture_s
                     for k, p in mod._exec._programs.items()}
        del mod, logits, loss
    _free(torch)
    with mx.cpu(0):
        hnet = _encoder_layer(mx, cfg["units"], cfg["heads"], cfg["ffn"])
        hnet.load_parameters(path)
        hmod = _encoder_module(mx, hnet, mx.cpu(0))
        host_outs, host_ms, host_grad = _module_steps(
            torch, hmod, _encoder_batch_nd(mx, x, valid, y), steps,
            lambda: None, grad_name=hnet.qkv.weight.name)
        del hmod, hnet
    first_rel = float(np.abs(outs[0] - gluon_prob).max()
                      / np.abs(gluon_prob).max())
    grad_rel = float(np.abs(grad - gluon_grad).max()
                     / np.abs(gluon_grad).max())
    host_rel = [float(np.abs(a - b).max() / np.abs(b).max())
                for a, b in zip(outs, host_outs)]
    host_grad_rel = float(np.abs(grad - host_grad).max()
                          / np.abs(host_grad).max())
    rtol = list(GLUON_FLASH_LOSS_RTOL) + [GLUON_FLASH_LOSS_RTOL[-1]] * (
        steps - len(GLUON_FLASH_LOSS_RTOL))
    losses = [float(-np.log(o[np.arange(len(y)), y.astype(int)]).mean())
              for o in outs]
    out = dict(layer="bert_24_1024_16 encoder layer (gluon_flash's) "
               "composed over Symbol inputs, SoftmaxOutput head, Module",
               **{k: cfg[k] for k in ("units", "heads", "ffn", "L", "B")},
               optimizer="sgd", lr=SYMBOLIC_ENCODER["lr"], steps=steps,
               losses=losses, first_output_rel_err_vs_gluon=first_rel,
               qkv_grad_rel_err_vs_gluon=grad_rel,
               output_rel_err_vs_host=host_rel,
               qkv_grad_rel_err_vs_host=host_grad_rel, rtol=rtol,
               grad_tol=GLUON_FLASH_GRAD_TOL,
               launches_first_step=launches, launches_after_capture=after,
               programs=programs, capture_s=capture_s,
               first_step_ms=ms[0], ms_per_step=float(np.median(ms[1:])),
               host_ms_per_step=float(np.median(host_ms)), trace=trace,
               gluon_hybrid=hybrid)
    check(first_rel <= rtol[0],
          f"symbolic encoder: step 1's output {first_rel} from the eager "
          f"Gluon step")
    check(grad_rel <= GLUON_FLASH_GRAD_TOL,
          f"symbolic encoder: qkv gradient {grad_rel} of max from the "
          f"eager Gluon step")
    check(all(e <= t for e, t in zip(host_rel, rtol))
          and host_grad_rel <= GLUON_FLASH_GRAD_TOL,
          f"symbolic encoder: outputs vs the host Module {host_rel}, "
          f"gradient {host_grad_rel}")
    check(all(v == 1 for v in launches.values()),
          f"symbolic encoder: B1-B3 wrapper launches in the first step "
          f"{launches}")
    check(all(v == 0 for v in after.values()),
          f"symbolic encoder: wrapper launches after capture {after}")
    check(trace.get("records_per_step") == dict.fromkeys(FLASH_NAMES, 1.0),
          f"symbolic encoder: B1-B3 records per traced step "
          f"{trace.get('records_per_step')}")
    check(programs == 2, f"symbolic encoder: {programs} programs")
    traced = {k: v * SYMBOLIC_ENCODER["traced_steps"]
              for k, v in trace["records_per_step"].items()}
    return out, launches, traced


def _phase_symbol_block(torch, mx, lenet_path, enc_path):
    """``export`` / ``SymbolBlock.imports`` of the hybridized LeNet, the
    layer's symbol as a hybridized SymbolBlock over its parameters, and
    the JAX package's fixture on the card and the host."""
    from mxnet_tpu_torch.gluon import SymbolBlock
    cfg = GLUON_FLASH
    rs = np.random.RandomState(0)
    lx = mx.nd.array(rs.rand(GLUON_MNIST["batch"], 1, 28, 28).astype(
        np.float32), ctx=mx.gpu(0))
    tmp = tempfile.mkdtemp(prefix="mxnet-symbolic-")
    res = {}
    try:
        with mx.gpu(0):
            lenet = _lenet(mx)
            lenet.load_parameters(lenet_path)
            lenet.hybridize(static_alloc=True)
            want = lenet(lx).asnumpy()
            sym_file = lenet.export(os.path.join(tmp, "lenet"))
            blk = SymbolBlock.imports(sym_file, "data",
                                      os.path.join(tmp, "lenet-0000.params"),
                                      ctx=mx.gpu(0))
            got = blk(lx).asnumpy()
            res["lenet_export"] = dict(
                rel_err=float(np.abs(got - want).max() / np.abs(want).max()),
                params=len(blk.collect_params()),
                device=str(blk.collect_params()[
                    next(iter(blk.collect_params().keys()))].data()
                    .data_torch.device))

            net = _encoder_layer(mx, cfg["units"], cfg["heads"], cfg["ffn"])
            net.load_parameters(enc_path)
            x, valid, _y = _encoder_batch(cfg)
            xs, vs = mx.nd.array(x), mx.nd.array(valid)
            want = net(xs, vs).asnumpy()
            sb = SymbolBlock(_encoder_symbol(mx, net, head=False),
                             [mx.sym.var("data"), mx.sym.var("valid_length")],
                             params=net.collect_params())
            sb.hybridize()
            first = sb(xs, vs).asnumpy()
            _dist_counts(zero=True)

            def call():
                return sb(xs, vs)

            replayed = call().asnumpy()
            launches = _dist_counts()
            records = _kernel_records(torch, call, names=FLASH_NAMES,
                                      warm=call, where="symbolic "
                                      "symbol_block")
            res["encoder_symbol_block"] = dict(
                first_rel_err=float(np.abs(first - want).max()
                                    / np.abs(want).max()),
                replay_rel_err=float(np.abs(replayed - want).max()
                                     / np.abs(want).max()),
                wrapper_launches_in_replay=launches,
                traced_records=records,
                cached_op=_sig_stats_rows(sb._cached_op.stats()))
            del sb, net, blk, lenet
        _free(torch)
        fixture = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                               SYMBOLIC_FIXTURE)
        g = mx.sym.load(fixture)
        arg_shapes, _, aux_shapes = g.infer_shape(**SYMBOLIC_FIXTURE_SHAPES)
        frs = np.random.RandomState(0)
        args = {n: (np.array([16.0, 0.0], np.float32) if n == "valid_length"
                    else (frs.randn(*s) * 0.5).astype(np.float32))
                for n, s in zip(g.list_arguments(), arg_shapes)}
        aux = {n: (frs.rand(*s) + 0.5).astype(np.float32)
               for n, s in zip(g.list_auxiliary_states(), aux_shapes)}
        outs = []                       # the card's, then the host's
        for where in (mx.gpu(0), mx.cpu(0)):
            ex = g.bind(where, {k: mx.nd.array(v, ctx=where)
                                for k, v in args.items()},
                        aux_states={k: mx.nd.array(v, ctx=where)
                                    for k, v in aux.items()},
                        grad_req="null")
            ex.forward(is_train=False)
            outs.append([o.asnumpy() for o in ex.forward(is_train=False)])
        res["jax_fixture"] = dict(
            file=SYMBOLIC_FIXTURE, outputs=g.list_outputs(),
            rel_err=[float(np.abs(a - b).max() / np.abs(b).max())
                     for a, b in zip(*outs)],
            rtol=GLUON_FLASH_LOSS_RTOL[0])
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    le, eb, jf = (res["lenet_export"], res["encoder_symbol_block"],
                  res["jax_fixture"])
    check(le["rel_err"] <= SYMBOLIC_BLOCK_TOL
          and le["device"].startswith("cuda"),
          f"symbolic symbol_block: LeNet imports {le}")
    check(eb["first_rel_err"] <= SYMBOLIC_BLOCK_TOL
          and eb["replay_rel_err"] <= SYMBOLIC_BLOCK_TOL,
          f"symbolic symbol_block: encoder SymbolBlock {eb}")
    check(all(v == 0 for v in eb["wrapper_launches_in_replay"].values())
          and eb["traced_records"]["flash_attention_fwd"] == 1,
          f"symbolic symbol_block: B1 in the CachedOp graph {eb}")
    check(all(e <= jf["rtol"] for e in jf["rel_err"]),
          f"symbolic symbol_block: the JAX fixture on the card {jf}")
    return res


def _phase_bucketing(torch, mx, path):
    from mxnet_tpu_torch.module import BucketingModule
    cfg = GLUON_FLASH
    x, valid, y = _encoder_batch(cfg)
    rows = []
    with mx.gpu(0):
        net = _encoder_layer(mx, cfg["units"], cfg["heads"], cfg["ffn"])
        net.load_parameters(path)
        symbol = _encoder_symbol(mx, net)

        def sym_gen(_L):
            return symbol, ("data", "valid_length"), ("softmax_label",)

        top = max(SYMBOLIC_BUCKETS)
        bm = BucketingModule(sym_gen, default_bucket_key=top,
                             context=mx.gpu(0), bucket_keys=SYMBOLIC_BUCKETS)
        b0 = _encoder_batch_nd(mx, x, valid, y, top)
        bm.bind(data_shapes=b0.provide_data, label_shapes=b0.provide_label)
        bm.set_params({p.name: p.data() for p in
                       net.collect_params().values()}, {})
        bm.init_optimizer(optimizer="sgd", optimizer_params={
            "learning_rate": SYMBOLIC_ENCODER["lr"]})
        for L in SYMBOLIC_BUCKETS:
            b = _encoder_batch_nd(mx, x, valid, y, L)
            _dist_counts(zero=True)
            ms = []
            for _ in range(SYMBOLIC_BUCKET_STEPS):
                t0 = time.perf_counter()
                bm.forward(b, is_train=True)
                bm.backward()
                bm.update()
                torch.cuda.synchronize()
                ms.append((time.perf_counter() - t0) * 1e3)
            ex = bm._buckets[L]._exec
            out = bm.get_outputs()[0].asnumpy()
            rows.append(dict(L=L, launches=_dist_counts(), step_ms=ms,
                             capture_s=sum(p.capture_s for p in
                                           ex._programs.values()),
                             finite=bool(np.isfinite(out).all())))
        names = [p.name for p in net.collect_params().values()]
        shared = all(bm._buckets[k]._exec.arg_dict[n]
                     is bm._buckets[top]._exec.arg_dict[n]
                     for k in SYMBOLIC_BUCKETS for n in names)
        programs = bm.num_compiles
        del bm, net
    _free(torch)
    out = dict(buckets=rows, programs=programs,
               program_bound=2 * len(SYMBOLIC_BUCKETS),
               one_weight_object_per_name=shared)
    check(shared, "symbolic bucketing: weights not shared across buckets")
    check(programs <= 2 * len(SYMBOLIC_BUCKETS),
          f"symbolic bucketing: {programs} programs")
    for r in rows:
        check(r["finite"] and all(v >= 1 for v in r["launches"].values()),
              f"symbolic bucketing: bucket {r}")
    return out


def _monitored_lenet(torch, mx, lenet_path):
    """A hybridized Gluon LeNet trained by Adam, traced for
    ``traced_steps`` steps without and then with a ``Monitor`` (interval
    1, ``tic`` before and ``toc`` after each step): graph launches and
    records a step in each, and the names the monitor statted."""
    cfg = SYMBOLIC_MONITOR
    rs = np.random.RandomState(3)
    x = rs.rand(cfg["batch"], 1, 28, 28).astype(np.float32)
    y = rs.randint(0, 10, cfg["batch"]).astype(np.float32)
    with mx.gpu(0):
        net = _lenet(mx)
        net.load_parameters(lenet_path, ctx=mx.gpu(0))
        net.hybridize(static_alloc=True)
        trainer = mx.gluon.Trainer(net.collect_params(), "adam",
                                   {"learning_rate": 1e-3})
        batch = (mx.nd.array(x), mx.nd.array(y))
        plain = _gluon_stepper(mx, trainer, batch, net=net)
        mon = mx.monitor.Monitor(interval=1)
        seen = []

        def watched():
            mon.tic()
            loss = plain()
            seen.append(mon.toc())
            return loss

        for _ in range(cfg["steps"]):
            plain()
        torch.cuda.synchronize()
        out = {}
        for tag, step in (("plain", plain), ("monitored", watched)):
            if tag == "monitored":
                mon.install(net)
            _trace_steps(torch, step, cfg["traced_steps"], 1.0, warm=step,
                         where=f"symbolic_monitor_{tag}")
            launches = TRACE_LAUNCHES[-1]["counted"]
            out[tag] = dict(graph_launches_per_step=len(launches)
                            / cfg["traced_steps"],
                            records_per_graph_launch=launches)
        mon.uninstall()
        names = sorted({n for res in seen for _s, n, _v in res})
        del net, trainer
    out["statted"] = names
    out["finite"] = all(isinstance(v, float) and np.isfinite(v)
                        for res in seen for _s, _n, v in res)
    return out


def phase_symbolic(torch, hybrid=None):
    """``symbolic``: the symbolic API on the card (module comment above
    ``SYMBOLIC_LENET``).  ``hybrid`` is ``gluon_hybrid``'s hybridized
    encoder layer (ms a step and its trace), printed beside the Module's.
    Returns B1-B3's wrapper launches in the encoder Module's run and
    their records in its traced steps."""
    import mxnet_tpu_torch as mx
    t0 = time.perf_counter()
    tmp = tempfile.mkdtemp(prefix="mxnet-symbolic-")
    try:
        lenet_path = os.path.join(tmp, "lenet.npz")
        enc_path = os.path.join(tmp, "encoder.npz")
        rs = np.random.RandomState(0)
        _lenet_weights(mx, lenet_path,
                       rs.rand(1, 1, 28, 28).astype(np.float32))
        _encoder_weights(mx, GLUON_FLASH, enc_path)
        lenet = _phase_lenet_symbol(torch, mx)
        monitored = _monitored_lenet(torch, mx, lenet_path)
        _free(torch)
        encoder, launches, traced = _phase_encoder_module(
            torch, mx, enc_path, hybrid)
        block = _phase_symbol_block(torch, mx, lenet_path, enc_path)
        bucketing = _phase_bucketing(torch, mx, enc_path)
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    emit("symbolic", dtype="float32", lenet_symbol=lenet,
         monitored_hybrid_lenet=monitored,
         encoder_module=encoder, symbol_block=block, bucketing=bucketing,
         seconds=time.perf_counter() - t0)
    names = monitored["statted"]
    check(monitored["plain"]["graph_launches_per_step"]
          == monitored["monitored"]["graph_launches_per_step"]
          and monitored["finite"]
          and any(n.endswith("weight") for n in names)
          and any(n.endswith("weight_grad") for n in names),
          f"symbolic: the monitored hybridized LeNet {monitored}")
    return dict(launches=launches, traced=traced,
                bucketing={r["L"]: r["launches"] for r in bucketing[
                    "buckets"]})


# ----------------------------------------------------------------- word_lm
# (a) examples/word_language_model.py's loop through the port at its own
# sizes: its synthetic grammar corpus (2000 sentences, RandomState(0)),
# embed 64, hidden 128, 2 LSTM layers, NTC, batch 16, seq 20, Adam 3e-3,
# hybridize(static_alloc=True), 3 epochs; the Xavier weights after
# mx.random.seed(1) are drawn on the host and loaded on the card, so the
# host run starts from them too.
# (b) Zaremba et al. 2014's "medium" LSTM LM, GluonNLP's
# standard_lstm_lm_650: WikiText-2's vocabulary (33,278), embed 650,
# hidden 650, 2 LSTM layers, dropout 0.5, bptt 35, batch 20, untied
# (tying would make the embedding's gradient dense), the embedding
# nn.Embedding(33278, 650, sparse_grad=True) and the decoder
# Dense(33278, flatten=False); hybridized, Trainer on Adam
# (lazy_update=True) at lr 1e-3; token ids from a seeded Zipf(1.1) over
# the vocabulary (numpy), so a batch touches a few hundred rows.
WORD_LM = dict(embed=64, hidden=128, layers=2, batch=16, seq=20, lr=3e-3,
               epochs=3, host_steps=3, seed=1)
WORD_LM_RTOL = 1e-5            # the first 3 losses, card vs host
WORD_LM_650 = dict(vocab=33278, embed=650, hidden=650, layers=2,
                   dropout=0.5, bptt=35, batch=20, lr=1e-3, zipf=1.1,
                   warm=2, steps=10, traced_steps=3, seed=0)
# one lazy-Adam step from the same weights and batch, card vs host: the
# loss (relative), the updated rows and moments (rtol, atol), the
# embedding's gradient (of its max)
WORD_LM_650_LOSS_RTOL = 1e-5
WORD_LM_650_ROW_TOL = (1e-4, 1e-6)
WORD_LM_650_GRAD_TOL = 1e-5
# nd.sparse on the card against the host: floats within this of the
# result's max, indices exactly
WORD_LM_SPARSE_TOL = 1e-5
WORD_LM_CSR = dict(rows=64, density=0.01)


def _word_lm_corpus(n_sentences=2000, seed=0):
    """``make_corpus`` of examples/word_language_model.py: token ids of
    subject-verb-object sentences from a tiny grammar, and the vocab."""
    rng = np.random.RandomState(seed)
    subjects = ["the cat", "a dog", "the bird", "my friend"]
    verbs = ["sees", "likes", "chases", "finds"]
    objects = ["the ball", "a fish", "the tree", "some food"]
    sentences = []
    for _ in range(n_sentences):
        sentences.append(subjects[rng.randint(4)].split()
                         + [verbs[rng.randint(4)]]
                         + objects[rng.randint(4)].split() + ["<eos>"])
    vocab = sorted({w for s in sentences for w in s} | {"<eos>"})
    w2i = {w: i for i, w in enumerate(vocab)}
    ids = np.array([w2i[w] for s in sentences for w in s], np.int32)
    return ids, vocab


def _word_lm_batches(ids, batch_size, seq_len):
    """``batchify`` of the example, as numpy (x, y) pairs."""
    n = (len(ids) - 1) // (batch_size * seq_len)
    usable = n * batch_size * seq_len
    x = ids[:usable].reshape(batch_size, -1)
    y = ids[1:usable + 1].reshape(batch_size, -1)
    return [(x[:, i:i + seq_len], y[:, i:i + seq_len])
            for i in range(0, x.shape[1] - seq_len + 1, seq_len)]


def _word_lm_model(mx, vocab, embed=64, hidden=128, layers=2, dropout=0.0,
                   sparse_grad=False):
    """The example's ``RNNModel`` on the port (its parameters by the same
    structural names); with ``dropout`` GluonNLP's dropout after the
    embedding, between the LSTM layers and before the decoder."""
    nn, rnn = mx.gluon.nn, mx.gluon.rnn

    class RNNModel(mx.gluon.HybridBlock):
        def __init__(self, **kw):
            super().__init__(**kw)
            with self.name_scope():
                self.embedding = nn.Embedding(vocab, embed,
                                              sparse_grad=sparse_grad)
                self.rnn = rnn.LSTM(hidden, num_layers=layers,
                                    layout="NTC", dropout=dropout)
                self.decoder = nn.Dense(vocab, flatten=False)
                self.drop = nn.Dropout(dropout) if dropout else None

        def hybrid_forward(self, F, x):
            h = self.embedding(x)
            if self.drop is not None:
                h = self.drop(h)
            h = self.rnn(h)
            if self.drop is not None:
                h = self.drop(h)
            return self.decoder(h)

    return RNNModel()


def _word_lm_step(mx, net, trainer, loss_fn, x, y, vocab):
    """One step of the example's loop; returns the mean loss."""
    with mx.autograd.record():
        logits = net(x)
        loss = loss_fn(logits.reshape((-1, vocab)),
                       y.reshape((-1,))).mean()
    loss.backward()
    trainer.step(x.shape[0])
    return loss


def _word_lm_weights(mx, path, vocab, seq, seed, **kw):
    """Xavier weights after ``mx.random.seed(seed)``, drawn on the host,
    saved to ``path``."""
    mx.random.seed(seed)
    with mx.cpu(0):
        net = _word_lm_model(mx, vocab, **kw)
        net.initialize(mx.init.Xavier())
        net(mx.nd.zeros((1, seq), dtype="int32"))
        net.save_parameters(path)


def _word_lm_example(mx, path):
    """(a): the example's 3 epochs on the card, its first steps on the
    host."""
    cfg = WORD_LM
    ids, vocab = _word_lm_corpus()
    V = len(vocab)
    counts = np.bincount(ids, minlength=V) / len(ids)
    nz = counts[counts > 0]
    unigram_ppl = math.exp(-(nz * np.log(nz)).sum())
    batches = _word_lm_batches(ids, cfg["batch"], cfg["seq"])
    _word_lm_weights(mx, path, V, cfg["seq"], cfg["seed"])
    loss_fn = mx.gluon.loss.SoftmaxCrossEntropyLoss()

    def run(ctx, epochs, steps=None):
        with ctx:
            net = _word_lm_model(mx, V)
            net.load_parameters(path)
            net.hybridize(static_alloc=True)
            trainer = mx.gluon.Trainer(net.collect_params(), "adam",
                                       {"learning_rate": cfg["lr"]})
            losses, epoch_s, ppl = [], [], []
            for _epoch in range(epochs):
                total, n = 0.0, 0
                t0 = time.perf_counter()
                for x, y in batches[:steps]:
                    loss = _word_lm_step(
                        mx, net, trainer, loss_fn,
                        mx.nd.array(x, dtype="int32"),
                        mx.nd.array(y, dtype="int32"), V)
                    losses.append(float(loss.asscalar()))
                    total += losses[-1]
                    n += 1
                epoch_s.append(time.perf_counter() - t0)
                ppl.append(math.exp(total / n))
            device = str(net.embedding.weight.data().data_torch.device)
            return losses, epoch_s, ppl, device, net._cached_op.stats()

    losses, epoch_s, ppl, device, stats = run(mx.gpu(0), cfg["epochs"])
    host, _s, _p, _d, _st = run(mx.cpu(0), 1, cfg["host_steps"])
    rel = [abs(a - b) / abs(b) for a, b in zip(losses, host)]
    out = dict(example="examples/word_language_model.py", vocab=V,
               tokens=int(len(ids)), batches_per_epoch=len(batches),
               unigram_ppl=unigram_ppl, ppl_by_epoch=ppl,
               seconds_per_epoch=epoch_s,
               ms_per_batch=[s / len(batches) * 1e3 for s in epoch_s],
               first_losses=losses[:8], host_losses=host,
               loss_rel_err=rel, device=device,
               programs=stats["programs"],
               capture_s=sum(s["capture_s"] for s in stats["signatures"]),
               pool_bytes=sum(s["pool_bytes"] for s in stats["signatures"]))
    check(device.startswith("cuda"), f"word_lm: weights on {device}")
    check(all(np.isfinite(ppl)) and ppl[-1] < unigram_ppl,
          f"word_lm: perplexity {ppl} against the unigram {unigram_ppl}")
    check(len(rel) == cfg["host_steps"]
          and all(e <= WORD_LM_RTOL for e in rel),
          f"word_lm: card vs host losses {rel}, want {WORD_LM_RTOL}")
    return out


def _zipf_tokens(rng, n, vocab, a):
    """``n`` token ids from Zipf(``a``) over ``vocab`` ranks (draws past
    the vocabulary are dropped)."""
    out = np.empty(0, np.int64)
    while out.size < n:
        z = rng.zipf(a, size=2 * n) - 1
        out = np.concatenate([out, z[z < vocab]])
    return out[:n].astype(np.int32)


def _word_lm_650_batches(cfg):
    rng = np.random.RandomState(cfg["seed"])
    out = []
    for _ in range(cfg["warm"] + cfg["steps"]):
        seq = _zipf_tokens(rng, cfg["batch"] * (cfg["bptt"] + 1),
                           cfg["vocab"], cfg["zipf"]).reshape(
            cfg["batch"], cfg["bptt"] + 1)
        out.append((seq[:, :-1], seq[:, 1:]))
    return out


def _word_lm_650_net(mx, path, sparse_grad, dropout):
    cfg = WORD_LM_650
    net = _word_lm_model(mx, cfg["vocab"], cfg["embed"], cfg["hidden"],
                         cfg["layers"], dropout=dropout,
                         sparse_grad=sparse_grad)
    net.load_parameters(path)
    net.hybridize(static_alloc=True)
    trainer = mx.gluon.Trainer(net.collect_params(), "adam",
                               {"learning_rate": cfg["lr"],
                                "lazy_update": True})
    return net, trainer


def _adam_state(trainer, param):
    """The Adam moments of ``param`` (host copies)."""
    i = trainer._params.index(param)
    mean, var = trainer._updater.states[i]
    return mean.asnumpy(), var.asnumpy()


def _word_lm_650_check(mx, path, batches, ctx):
    """Two lazy-Adam steps of the dropout-free model from the saved
    weights: the state before the second step and after it, its loss and
    its embedding gradient (host copies)."""
    cfg = WORD_LM_650
    loss_fn = mx.gluon.loss.SoftmaxCrossEntropyLoss()
    with ctx:
        net, trainer = _word_lm_650_net(mx, path, True, 0.0)
        emb = net.embedding.weight
        out = {}
        for i, (x, y) in enumerate(batches[:2]):
            if i == 1:
                out["before"] = (emb.data().asnumpy(),
                                 *_adam_state(trainer, emb))
            loss = _word_lm_step(mx, net, trainer, loss_fn,
                                 mx.nd.array(x, dtype="int32"),
                                 mx.nd.array(y, dtype="int32"),
                                 cfg["vocab"])
        out["loss"] = float(loss.asscalar())
        out["grad"] = emb.grad().asnumpy()
        out["after"] = (emb.data().asnumpy(), *_adam_state(trainer, emb))
        out["device"] = str(emb.data().data_torch.device)
    return out


def _word_lm_650_run(torch, mx, path, batches, sparse_grad):
    """(b): 2 warm-up and 10 timed steps at the configuration's dropout:
    ms a step, host syncs a step, rows touched a step and a traced
    step's split."""
    from mxnet_tpu_torch.ndarray import sparse
    cfg = WORD_LM_650
    loss_fn = mx.gluon.loss.SoftmaxCrossEntropyLoss()
    with mx.gpu(0):
        net, trainer = _word_lm_650_net(mx, path, sparse_grad,
                                        cfg["dropout"])
        data = [(mx.nd.array(x, dtype="int32"),
                 mx.nd.array(y, dtype="int32")) for x, y in batches]
        losses, ms = [], []
        for i, (x, y) in enumerate(data):
            if i == cfg["warm"]:
                syncs0 = sum(sparse.HOST_SYNCS.values())
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            losses.append(_word_lm_step(mx, net, trainer, loss_fn, x, y,
                                        cfg["vocab"]))
            torch.cuda.synchronize()
            ms.append((time.perf_counter() - t0) * 1e3)
        syncs = sum(sparse.HOST_SYNCS.values()) - syncs0
        losses = [float(v.asscalar()) for v in losses]
        step_ms = float(np.median(ms[cfg["warm"]:]))
        x, y = data[-1]
        trace = _trace_steps(torch, functools.partial(
            _word_lm_step, mx, net, trainer, loss_fn, x, y, cfg["vocab"]),
            cfg["traced_steps"], step_ms)
        fused = trainer.fused_stats()
        stats = net._cached_op.stats()
    rows = [int(np.unique(x).size) for x, _y in batches[cfg["warm"]:]]
    return dict(sparse_grad=sparse_grad, losses=losses,
                step_ms=step_ms, step_ms_all=ms,
                host_syncs_per_step=syncs / cfg["steps"],
                rows_touched_per_step=float(np.mean(rows)),
                rows_touched=rows, fused_update_programs=fused[
                    "update_programs"], programs=stats["programs"],
                **trace)


def _rnn_dropout_replays(mx):
    """A hybridized 2-layer LSTM with inter-layer dropout, recorded three
    times on one input: the eager first call and two replays of its
    graph.  Whether the replays drew different masks, and the programs
    the layer holds."""
    with mx.gpu(0):
        cfg = WORD_LM_650
        layer = mx.gluon.rnn.LSTM(cfg["hidden"], num_layers=cfg["layers"],
                                  dropout=cfg["dropout"],
                                  input_size=cfg["embed"])
        layer.initialize()
        layer.hybridize(static_alloc=True)
        x = mx.nd.array(np.random.RandomState(0).rand(
            cfg["bptt"], cfg["batch"], cfg["embed"]).astype(np.float32))
        outs = []
        for _ in range(3):
            with mx.autograd.record():
                outs.append(layer(x).asnumpy())
        return dict(replays_differ=not np.array_equal(outs[1], outs[2]),
                    programs=layer._cached_op.stats()["programs"])


def _word_lm_capture_refusal(torch, mx):
    """A dense-to-row-sparse conversion attempted inside a CUDA-graph
    capture: the error's text (None when nothing raised)."""
    from mxnet_tpu_torch.base import MXNetError
    g = torch.cuda.CUDAGraph()
    stream = torch.cuda.Stream()
    grad = mx.nd.NDArray._wrap(torch.ones(16, 4, device="cuda"))
    stream.wait_stream(torch.cuda.current_stream())
    try:
        with torch.cuda.stream(stream):
            with torch.cuda.graph(g, stream=stream):
                grad.tostype("row_sparse")
    except MXNetError as e:
        return str(e)
    finally:
        torch.cuda.current_stream().wait_stream(stream)
        torch.cuda.synchronize()
    return None


def _word_lm_sparse_surface(mx, ctx):
    """``nd.sparse`` on ``ctx``: CSR dot with and without transpose_a
    against a dense product of the same matrix, a row-sparse round
    trip, retain, and row_sparse_pull from a ``device`` store (host
    copies)."""
    cfg, csr = WORD_LM_650, WORD_LM_CSR
    rng = np.random.RandomState(0)
    V, E = cfg["vocab"], cfg["embed"]
    dense = np.zeros((csr["rows"], V), np.float32)
    mask = rng.rand(*dense.shape) < csr["density"]
    dense[mask] = rng.randn(int(mask.sum())).astype(np.float32)
    emb = rng.randn(V, E).astype(np.float32)
    rhs_t = rng.randn(csr["rows"], E).astype(np.float32)
    rows = np.unique(rng.randint(0, V, 300)).astype(np.int32)
    grad = np.zeros((V, E), np.float32)
    grad[rows] = rng.randn(rows.size, E).astype(np.float32)
    keep = rows[::3]
    with ctx:
        sp, nd = mx.nd.sparse, mx.nd
        a = sp.csr_matrix(dense)
        a_dense = nd.array(dense)
        out = dict(
            dot=sp.dot(a, nd.array(emb)).asnumpy(),
            dot_dense=nd.dot(a_dense, nd.array(emb)).asnumpy(),
            dot_t=sp.dot(a, nd.array(rhs_t), transpose_a=True).asnumpy(),
            dot_t_dense=nd.dot(a_dense, nd.array(rhs_t),
                               transpose_a=True).asnumpy(),
            csr_indptr=a.indptr.asnumpy(), csr_indices=a.indices.asnumpy())
        rsp = nd.array(grad).tostype("row_sparse")
        kept = sp.retain(rsp, nd.array(keep, dtype="int32"))
        out.update(rsp_indices=rsp.indices.asnumpy(),
                   rsp_data=rsp.data.asnumpy(),
                   rsp_dense=rsp.tostype("default").asnumpy(),
                   kept_indices=kept.indices.asnumpy(),
                   kept_dense=kept.asnumpy())
        kv = mx.kvstore.create("device")
        kv.init("emb", nd.array(emb))
        pulled = nd.zeros((keep.size, E))
        kv.row_sparse_pull("emb", out=pulled,
                           row_ids=nd.array(keep, dtype="int32"))
        out["pulled"] = pulled.asnumpy()
    out["want_dot"], out["want_dot_t"] = dense @ emb, dense.T @ rhs_t
    out["want_pulled"], out["rows"], out["keep"] = emb[keep], rows, keep
    out["grad"] = grad
    return out


def _sparse_surface_errors(card, host):
    """Each float result's error against the host's (of its max) and
    whether each index array is equal."""
    floats = ("dot", "dot_dense", "dot_t", "dot_t_dense", "rsp_data",
              "rsp_dense", "kept_dense", "pulled")
    errs = {k: float(np.abs(card[k] - host[k]).max()
                     / max(float(np.abs(host[k]).max()), 1e-30))
            for k in floats}
    # the dense products of the same matrix
    errs["dot_vs_dense"] = float(np.abs(card["dot"] - card["dot_dense"])
                                 .max() / np.abs(card["dot_dense"]).max())
    errs["dot_t_vs_dense"] = float(
        np.abs(card["dot_t"] - card["dot_t_dense"]).max()
        / np.abs(card["dot_t_dense"]).max())
    exact = {k: bool(np.array_equal(card[k], host[k])) for k in
             ("csr_indptr", "csr_indices", "rsp_indices", "kept_indices")}
    exact["rsp_rows"] = bool(np.array_equal(card["rsp_indices"],
                                            card["rows"]))
    exact["kept_rows"] = bool(np.array_equal(card["kept_indices"],
                                             card["keep"]))
    exact["pulled_rows"] = bool(np.array_equal(card["pulled"],
                                               card["want_pulled"]))
    return errs, exact


def phase_word_lm(torch):
    """``word_lm``: examples/word_language_model.py's loop on the card
    and Zaremba's medium LM with a row-sparse embedding (module comment
    above ``WORD_LM``)."""
    import mxnet_tpu_torch as mx
    from mxnet_tpu_torch.ndarray import sparse
    t0 = time.perf_counter()
    cfg = WORD_LM_650
    tmp = tempfile.mkdtemp(prefix="mxnet-word-lm-")
    split, since = {}, [t0]

    def lap(name):
        split[name] = time.perf_counter() - since[0]
        since[0] += split[name]

    try:
        example = _word_lm_example(mx, os.path.join(tmp, "lm.npz"))
        _free(torch)
        lap("example")
        path = os.path.join(tmp, "lm650.npz")
        _word_lm_weights(mx, path, cfg["vocab"], cfg["bptt"], cfg["seed"],
                         embed=cfg["embed"], hidden=cfg["hidden"],
                         layers=cfg["layers"])
        batches = _word_lm_650_batches(cfg)
        lap("medium_weights")
        runs = [_word_lm_650_run(torch, mx, path, batches, s)
                for s in (True, False)]
        _free(torch)
        lap("medium_runs")
        card = _word_lm_650_check(mx, path, batches, mx.gpu(0))
        lap("step_check_card")
        host = _word_lm_650_check(mx, path, batches, mx.cpu(0))
        lap("step_check_host")
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    _free(torch)
    refusal = _word_lm_capture_refusal(torch, mx)
    dropout = _rnn_dropout_replays(mx)
    surface_card = _word_lm_sparse_surface(mx, mx.gpu(0))
    surface_host = _word_lm_sparse_surface(mx, mx.cpu(0))
    lap("sparse_surface")
    surface, surface_exact = _sparse_surface_errors(surface_card,
                                                    surface_host)
    # the step's check (module comment): the second batch's rows
    touched = np.unique(batches[1][0])
    untouched = np.setdiff1d(np.arange(cfg["vocab"]), touched)
    frozen = all(np.array_equal(a[untouched], b[untouched])
                 for a, b in zip(card["before"], card["after"]))
    frozen_host = all(np.array_equal(a[untouched], b[untouched])
                      for a, b in zip(host["before"], host["after"]))
    rtol, atol = WORD_LM_650_ROW_TOL
    row_errs = [float(np.max(np.abs(c[touched] - h[touched])
                             / (atol + rtol * np.abs(h[touched]))))
                for c, h in zip(card["after"], host["after"])]
    loss_rel = abs(card["loss"] - host["loss"]) / abs(host["loss"])
    grad_err = float(np.abs(card["grad"] - host["grad"]).max()
                     / np.abs(host["grad"]).max())
    sparse_run = runs[0]
    head = float(np.mean(sparse_run["losses"][:3]))
    tail = float(np.mean(sparse_run["losses"][-3:]))
    emit("word_lm", dtype="float32", example=example,
         medium=dict(config="Zaremba et al. 2014 medium "
                     "(GluonNLP standard_lstm_lm_650), untied",
                     **{k: v for k, v in cfg.items()}),
         runs=runs, step_check=dict(
             loss_card=card["loss"], loss_host=host["loss"],
             loss_rel_err=loss_rel, grad_err=grad_err,
             touched_rows=int(touched.size),
             row_err_over_tol=row_errs, untouched_frozen=frozen,
             untouched_frozen_host=frozen_host, device=card["device"]),
         capture_refusal=refusal, rnn_dropout=dropout,
         sparse_surface=surface,
         sparse_surface_exact=surface_exact,
         host_syncs=dict(sparse.HOST_SYNCS),
         seconds=time.perf_counter() - t0, seconds_split=split)
    check(card["device"].startswith("cuda"),
          f"word_lm: the medium LM's weights on {card['device']}")
    check(loss_rel <= WORD_LM_650_LOSS_RTOL,
          f"word_lm: card vs host loss {loss_rel}")
    check(grad_err <= WORD_LM_650_GRAD_TOL,
          f"word_lm: card vs host embedding gradient {grad_err}")
    check(all(e <= 1.0 for e in row_errs),
          f"word_lm: updated rows card vs host {row_errs} of the tolerance")
    check(frozen and frozen_host,
          f"word_lm: untouched rows or moments moved ({frozen}, "
          f"{frozen_host})")
    check(all(np.isfinite(sparse_run["losses"])) and tail < head,
          f"word_lm: the sparse run's losses {head} -> {tail}")
    check(sparse_run["host_syncs_per_step"] == 1.0
          and runs[1]["host_syncs_per_step"] == 0.0,
          f"word_lm: host syncs a step {[r['host_syncs_per_step'] for r in runs]}")
    check(refusal is not None and "row_sparse" in refusal,
          f"word_lm: tostype under capture: {refusal}")
    check(dropout["replays_differ"] and dropout["programs"] == 1,
          f"word_lm: the LSTM's dropout under replay: {dropout}")
    check(all(v <= WORD_LM_SPARSE_TOL for v in surface.values())
          and all(surface_exact.values()),
          f"word_lm: nd.sparse on the card: {surface} {surface_exact}")


# -------------------------------------------------------------- model_zoo
# (a) resnet50_v1 (1000 classes) trained at 224x224, batch 32, SGD with
# momentum 0.9 and wd 1e-4 at lr 0.0125 (0.1 for batch 256, scaled
# linearly: Goyal et al. 2017) on one fixed seeded batch: 2 eager steps,
# then hybridize(static_alloc=True) and 2 warm-up and 10 timed steps.
# The weights: MSRAPrelu (He et al. 2015), as GluonCV's ImageNet
# recipes.  (b) every family of the model zoo's table (ResNet V1 and V2
# with each block kind, VGG, AlexNet, MobileNet V1 and V2, SqueezeNet,
# DenseNet, Inception V3; tests/test_torch_model_zoo*.py hold the
# names to the JAX package on the host) in inference mode on the card
# against the port on the host, the host's weights carried across by
# save_parameters / load_parameters, batch 2 at the smallest input the
# family takes (below).
MODEL_ZOO = dict(model="resnet50_v1", classes=1000, image=224, batch=32,
                 lr=0.0125, momentum=0.9, wd=1e-4, eager_steps=2, warm=2,
                 steps=5, traced_steps=3, seed=0)
MODEL_ZOO_FIRST_RTOL = 1e-5     # first hybridized loss vs the eager one
MODEL_ZOO_TOL = 1e-4            # logits, card vs host, of max|logit|
MODEL_ZOO_BATCH = 2
MODEL_ZOO_FAMILIES = ("resnet18_v1", "resnet50_v1", "resnet18_v2",
                      "resnet50_v2", "vgg11", "alexnet", "mobilenet1.0",
                      "mobilenetv2_1.0", "squeezenet1.0", "densenet121",
                      "inceptionv3")
# the smallest input of each family (AlexNet's 11x11 stride-4 stem and
# three 3x3 stride-2 pools need 63; Inception V3 ends in an 8x8 pool)
MODEL_ZOO_INPUT = {"alexnet": 63, "inceptionv3": 299}
MODEL_ZOO_INPUT_DEFAULT = 32


def _zoo_train_step(mx, net, trainer, loss_fn, x, y):
    with mx.autograd.record():
        loss = loss_fn(net(x), y).mean()
    loss.backward()
    trainer.step(x.shape[0])
    return loss


def _zoo_resnet50(torch, mx):
    """(a): ResNet-50's eager then hybridized training steps."""
    cfg = MODEL_ZOO
    rng = np.random.RandomState(cfg["seed"])
    x = rng.rand(cfg["batch"], 3, cfg["image"], cfg["image"]) \
        .astype(np.float32)
    y = rng.randint(0, cfg["classes"], cfg["batch"]).astype(np.int32)
    loss_fn = mx.gluon.loss.SoftmaxCrossEntropyLoss()
    mx.random.seed(cfg["seed"])
    with mx.gpu(0):
        net = mx.gluon.model_zoo.get_model(cfg["model"],
                                           classes=cfg["classes"])
        net.initialize(mx.init.MSRAPrelu())
        xs, ys = mx.nd.array(x), mx.nd.array(y, dtype="int32")
        trainer = mx.gluon.Trainer(
            net.collect_params(), "sgd",
            {"learning_rate": cfg["lr"], "momentum": cfg["momentum"],
             "wd": cfg["wd"]})
        losses, ms = [], []

        def timed():
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            losses.append(_zoo_train_step(mx, net, trainer, loss_fn, xs,
                                          ys))
            torch.cuda.synchronize()
            ms.append((time.perf_counter() - t0) * 1e3)

        for _ in range(cfg["eager_steps"]):
            timed()
        # the eager loss from the state the first hybridized step starts
        # from (a training forward: batch statistics)
        with mx.autograd.record():
            eager_loss = float(loss_fn(net(xs), ys).mean().asscalar())
        net.hybridize(static_alloc=True)
        for _ in range(cfg["warm"] + cfg["steps"]):
            timed()
        losses = [float(v.asscalar()) for v in losses]
        e = cfg["eager_steps"]
        step_ms = float(np.median(ms[e + cfg["warm"]:]))
        trace = _trace_steps(torch, functools.partial(
            _zoo_train_step, mx, net, trainer, loss_fn, xs, ys),
            cfg["traced_steps"], step_ms)
        stats = net._cached_op.stats()
        fused = trainer.fused_stats()
        device = str(net.output.weight.data().data_torch.device)
    first_rel = abs(losses[e] - eager_loss) / abs(eager_loss)
    out = dict(model=cfg["model"], image=cfg["image"], batch=cfg["batch"],
               optimizer="sgd", lr=cfg["lr"], momentum=cfg["momentum"],
               wd=cfg["wd"], losses=losses, eager_loss=eager_loss,
               first_hybrid_rel_err=first_rel, eager_ms=ms[:e],
               step_ms=step_ms, samples_per_s=cfg["batch"] / step_ms * 1e3,
               step_ms_all=ms, device=device,
               capture_s=sum(s["capture_s"] for s in stats["signatures"]),
               pool_bytes=sum(s["pool_bytes"] for s in stats["signatures"]),
               programs=stats["programs"],
               update_capture_s=fused["capture_s"],
               update_programs=fused["update_programs"], **trace)
    check(device.startswith("cuda"), f"model_zoo: weights on {device}")
    check(first_rel <= MODEL_ZOO_FIRST_RTOL,
          f"model_zoo: first hybridized loss vs eager {first_rel}")
    check(all(np.isfinite(losses))
          and np.mean(losses[-3:]) < np.mean(losses[:3]),
          f"model_zoo: ResNet-50 losses {losses}")
    return out


def _zoo_families(mx, tmp):
    """(b): each family of the table, card against host."""
    from mxnet_tpu_torch.gluon.model_zoo import vision
    rows = []
    for name in MODEL_ZOO_FAMILIES:
        size = MODEL_ZOO_INPUT.get(name, MODEL_ZOO_INPUT_DEFAULT)
        x = np.random.RandomState(len(name)).rand(
            MODEL_ZOO_BATCH, 3, size, size).astype(np.float32)
        path = os.path.join(tmp, f"{name}.npz")
        t0 = time.perf_counter()
        mx.random.seed(0)
        with mx.cpu(0):
            host = vision.get_model(name)
            host.initialize(mx.init.MSRAPrelu())
            want = host(mx.nd.array(x)).asnumpy()
            host.save_parameters(path)
        with mx.gpu(0):
            net = vision.get_model(name)
            net.load_parameters(path)
            got = net(mx.nd.array(x)).asnumpy()
            device = str(next(iter(net.collect_params().values()))
                         .data().data_torch.device)
        del host, net
        err = float(np.abs(got - want).max() / np.abs(want).max())
        rows.append(dict(model=name, input=size, logits=list(got.shape),
                         max_logit=float(np.abs(want).max()), err=err,
                         device=device,
                         seconds=time.perf_counter() - t0))
    return rows


def phase_model_zoo(torch):
    """``model_zoo``: ResNet-50 training and every model of the zoo on
    the card (module comment above ``MODEL_ZOO``)."""
    import mxnet_tpu_torch as mx
    t0 = time.perf_counter()
    resnet = _zoo_resnet50(torch, mx)
    _free(torch)
    t1 = time.perf_counter()
    tmp = tempfile.mkdtemp(prefix="mxnet-model-zoo-")
    try:
        families = _zoo_families(mx, tmp)
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    _free(torch)
    emit("model_zoo", dtype="float32", resnet50=resnet, families=families,
         seconds=time.perf_counter() - t0,
         seconds_split=dict(resnet50=t1 - t0,
                            families=time.perf_counter() - t1))
    from mxnet_tpu_torch.gluon.model_zoo import vision
    kinds = {type(vision.get_model(n)).__name__ for n in vision._MODELS}
    tried = {type(vision.get_model(r["model"])).__name__ for r in families}
    bad = [r for r in families if not (r["err"] <= MODEL_ZOO_TOL
                                       and r["device"].startswith("cuda"))]
    check(tried == kinds and not bad,
          f"model_zoo: card vs host logits {bad}, families {tried}")
    return resnet["step_ms"]


# -------------------------------------------------------------- imagenet
# examples/train_imagenet.py's pipeline as the example runs it on an
# accelerator (the example imports jax, so this is its recipe, as
# gluon_ssd is): its synth_rec shard of 256 class-coloured PNG records at
# the ImageNet shape its docstring names (--model resnet50_v1 --shape
# 224), written by the port's built-in PNG codec; ImageRecordIter
# (shuffle, rand_mirror, scale 1/255, 2 decode threads) at batch 32; the
# zoo's resnet50_v1 with Xavier weights cast to bfloat16 (the batch cast
# on the card before the step); parallel.ShardedTrainer (dp 1, SGD lr
# 0.02 momentum 0.9, the example's loss in float32) for the example's 60
# iterations (7.5 epochs, so reset() runs), then write_back() and the
# train-set accuracy; then the same recipe in float32.  Checks: the
# example's criterion (last loss <= 0.9 x the first, accuracy >= 0.5) on
# the float32 run (bfloat16's trajectory is chaotic: its losses must be
# finite), every batch on the card, the first 2 batches equal bit for bit
# to the same iterator's under mx.cpu(0), and per traced step two copies
# to the card (data, label) and one back (the loss the example reads).
# The idle share is busy over the traced window's own time: 3 steps in
# the middle of an epoch after a reset, as the loop meets the producer.
# (b) the native library built on the card's machine; its JPEG tier must
# be what the probe of that machine found (CARD_HAS_LIBJPEG: no
# /usr/include/jpeglib.h, ldconfig lists only CUDA's libnvjpeg; cv2 and
# PIL import there).  (c) one ImageIter and one ImageDetIter batch under
# the augmenter lists on the card, equal to the host's, one copy a field.
CARD_HAS_LIBJPEG = False
CARD_HAS_CV2 = True
CARD_HAS_PIL = True
IMAGENET = dict(model="resnet50_v1", records=256, image=224, classes=6,
                batch=32, iters=60, lr=0.02, momentum=0.9, threads=2,
                dtype="bfloat16", seed=0, host_batches=2, drain_steps=4,
                traced_steps=3, producer_batches=4)
IMAGENET_FIXTURE = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                                "tests", "fixtures", "jpeg_records.npz")
IMAGENET_JPEG_TOL = 6.0       # mean |pixel diff| (tests/test_native.py:158)
IMAGENET_AUG = dict(records=16, image=64, crop=56, batch=8)


def _synth_rec(path, n, shape, n_classes, seed=0):
    """``train_imagenet.py``'s ``synth_rec`` (im2rec layout), each image
    encoded by the port's built-in PNG codec (8 threads: zlib releases
    the GIL; the draws stay in the example's order)."""
    from concurrent.futures import ThreadPoolExecutor
    from mxnet_tpu_torch import recordio
    from mxnet_tpu_torch.image import image as image_mod
    rng = np.random.RandomState(seed)
    classes, images = [], []
    for _ in range(n):
        cls = rng.randint(n_classes)
        base = np.zeros((shape, shape, 3), np.float32)
        base[..., cls % 3] = 80 + 40 * (cls // 3)
        classes.append(cls)
        images.append(np.clip(base + rng.randn(shape, shape, 3) * 25, 0,
                              255).astype(np.uint8))
    with ThreadPoolExecutor(8) as pool:
        pngs = list(pool.map(image_mod._png_encode, images))
    rec = recordio.MXIndexedRecordIO(path + ".idx", path + ".rec", "w")
    for i, (cls, png) in enumerate(zip(classes, pngs)):
        rec.write_idx(i, recordio.pack(recordio.IRHeader(0, float(cls), i, 0),
                                       png))
    rec.close()


def _imagenet_iter(mx, rec, cfg, threads=None, **kw):
    return mx.io.ImageRecordIter(
        path_imgrec=rec, data_shape=(3, cfg["image"], cfg["image"]),
        batch_size=cfg["batch"], shuffle=True, rand_mirror=True,
        scale=1.0 / 255, preprocess_threads=threads or cfg["threads"], **kw)


def _copies(torch, prof):
    """Device copy records of a trace by direction."""
    cuda = torch.autograd.DeviceType.CUDA
    out = dict(HtoD=0, DtoH=0, DtoD=0)
    for e in prof.events():
        if getattr(e, "device_type", None) != cuda:
            continue
        for k in out:
            if f"Memcpy {k}" in e.name:
                out[k] += 1
    return out


def _imagenet_train(torch, mx, rec, cfg):
    """(a): the example's loop; returns its numbers."""
    from mxnet_tpu_torch import parallel
    from mxnet_tpu_torch.gluon.model_zoo import vision
    mx.random.seed(cfg["seed"])
    it = _imagenet_iter(mx, rec, cfg)
    net = vision.get_model(cfg["model"], classes=cfg["classes"])
    net.initialize(mx.init.Xavier())
    dtype = cfg["dtype"]
    if dtype is not None:
        net.cast(dtype)

    def loss_fn(logits, labels):
        logp = torch.log_softmax(logits.float(), dim=-1)
        return -logp.gather(1, labels[:, None].long()).mean()

    example = mx.nd.zeros((cfg["batch"], 3, cfg["image"], cfg["image"]),
                          dtype=dtype or "float32")
    trainer = parallel.ShardedTrainer(
        net, loss_fn, parallel.make_mesh(dp=1, tp=1, sp=1),
        optimizer="sgd", optimizer_params={"learning_rate": cfg["lr"],
                                           "momentum": cfg["momentum"]},
        example_inputs=(example,), n_labels=1,
        dtype=getattr(torch, dtype) if dtype is not None else None)
    devices, first = set(), []

    def one():
        """One iteration of the example's loop: (loss, ms waiting in
        next(), ms of the whole iteration)."""
        t0 = time.perf_counter()
        batch = it.next()
        t1 = time.perf_counter()
        x, lab = batch.data[0], batch.label[0]
        devices.update({x.data_torch.device.type, lab.data_torch.device.type})
        if len(first) < cfg["host_batches"]:
            first.append((x.asnumpy(), lab.asnumpy()))
        if dtype is not None:
            x = x.astype(dtype)         # the AMP cast, on the card
        loss = float(trainer.step(x, lab.astype("int32")))
        t2 = time.perf_counter()
        return loss, (t1 - t0) * 1e3, (t2 - t0) * 1e3

    losses, waits, step_ms = [], [], []
    t_train = time.perf_counter()
    while len(losses) < cfg["iters"]:
        try:
            while len(losses) < cfg["iters"]:
                loss, wait, ms = one()
                losses.append(loss)
                waits.append(wait)
                step_ms.append(ms)
        except StopIteration:
            pass
        it.reset()
    train_s = time.perf_counter() - t_train
    per_epoch = -(-cfg["records"] // cfg["batch"])
    median_ms = float(np.median(step_ms[per_epoch:]))

    # the example's evaluation, right after its iterations
    trainer.write_back()
    it.reset()
    metric = mx.metric.Accuracy()
    for batch in it:
        x = batch.data[0]
        out = net(x.astype(dtype) if dtype is not None else x)
        metric.update([batch.label[0]], [out])
    _name, acc = metric.get()
    # then three traced iterations of the loop (next, step, the loss
    # read) in the middle of an epoch, as the untraced loop runs them:
    # the uncounted warm-up resets the iterator (dropping what the
    # producer queued during the trace's pad) and runs drain_steps
    # iterations, so each traced next() meets the producer as the loop
    # does
    traced = []

    def drain():
        it.reset()
        for _ in range(cfg["drain_steps"]):
            one()

    with _profiled(torch, warm=drain,
                   where=f"imagenet {dtype or 'float32'}") as prof:
        t0 = time.perf_counter()
        for _ in range(cfg["traced_steps"]):
            traced.append(one())
        torch.cuda.synchronize()
        traced_ms = (time.perf_counter() - t0) / cfg["traced_steps"] * 1e3
    n = cfg["traced_steps"]
    copies = {k: v / n for k, v in _copies(torch, prof).items()}
    busy_ms = _busy_union_us(torch, prof) / n / 1e3
    kernels = sum(e.count for e in prof.key_averages()
                  if _kernel_us(e, torch) is not None) / n

    it.close()
    progs = list(trainer._programs.values())
    out = dict(model=cfg["model"], image=cfg["image"], batch=cfg["batch"],
               records=cfg["records"], iters=cfg["iters"],
               dtype=dtype or "float32", seed=cfg["seed"],
               losses=losses, accuracy=float(acc),
               step_ms=median_ms, step_ms_all=step_ms,
               wait_ms=float(np.median(waits[per_epoch:])),
               wait_ms_all=waits, samples_per_s=cfg["batch"] / median_ms * 1e3,
               train_seconds=train_s, devices=sorted(devices),
               programs=len(progs), replays=sum(p.replays for p in progs),
               capture_s=sum(p.capture_s for p in progs),
               traced_steps=n, traced_step_ms=traced_ms,
               traced_wait_ms=[w for _l, w, _m in traced],
               copies_per_step=copies, device_busy_ms_per_step=busy_ms,
               # idle over the traced window's own time, and the same busy
               # time over the untraced loop's median step
               device_idle_share=1.0 - busy_ms / traced_ms,
               idle_share_of_untraced_median=1.0 - busy_ms / median_ms,
               device_records_per_step=kernels)
    return out, first


def _imagenet_host_batches(mx, rec, cfg, first):
    """The first batches of the same iterator under ``mx.cpu(0)`` from
    the same seed, against the card's."""
    with mx.cpu(0):
        it = _imagenet_iter(mx, rec, cfg)
        host = [it.next() for _ in range(len(first))]
        it.close()
    equal = [bool(np.array_equal(b.data[0].asnumpy(), d)
                  and np.array_equal(b.label[0].asnumpy(), lab))
             for b, (d, lab) in zip(host, first)]
    devices = sorted({b.data[0].data_torch.device.type for b in host})
    return equal, devices


def _imagenet_producer(mx, rec, cfg):
    """The producer's ms a batch (``_next_batch_sync``: read, decode,
    augment, assemble in pinned memory) with 1 and 2 decode threads."""
    out = {}
    for threads in (1, 2):
        it = _imagenet_iter(mx, rec, cfg, threads=threads)
        it._stop_producer()
        it._pos = 0
        ms = []
        for _ in range(cfg["producer_batches"]):
            t0 = time.perf_counter()
            it._next_batch_sync(it._ctx)
            ms.append((time.perf_counter() - t0) * 1e3)
        it.close()
        out[threads] = dict(ms=float(np.median(ms)), ms_all=ms)
    return out


def _imagenet_native(mx, rec, cfg):
    """(b): the native library and the codec tiers on this machine."""
    from mxnet_tpu_torch import recordio
    from mxnet_tpu_torch.image import image as image_mod
    from mxnet_tpu_torch.lib import nativelib

    def imports(name):
        try:
            __import__(name)
            return True
        except ImportError:
            return False

    t0 = time.perf_counter()
    ok = nativelib.available()
    build_s = time.perf_counter() - t0
    out = dict(available=ok, build_s=build_s,
               library=os.path.basename(nativelib.library_path()),
               jpeg=nativelib.jpeg_available(),
               jpeg_build_error=nativelib.jpeg_build_error(),
               cv2=imports("cv2"), pil=imports("PIL.Image"),
               backend=image_mod._BACKEND)
    check(ok, "imagenet: the native library did not build or load")
    reader = nativelib.NativeRecordReader(rec)
    native = [reader.read_at(o) for o in reader.index()]
    reader.close()
    plain, rd = [], recordio.MXRecordIO(rec, "r")
    while True:
        s = rd.read()
        if s is None:
            break
        plain.append(s)
    rd.close()
    out["records_equal"] = native == plain and len(plain) == cfg["records"]
    tmp = tempfile.mkdtemp(prefix="mxnet-imagenet-csv-")
    try:
        path = os.path.join(tmp, "d.csv")
        np.savetxt(path, np.random.RandomState(0).randn(64, 9)
                   .astype(np.float32), delimiter=",", fmt="%.7g")
        out["csv_equal"] = bool(np.array_equal(
            nativelib.csv_load(path),
            np.loadtxt(path, delimiter=",", dtype=np.float32, ndmin=2)))
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    with np.load(IMAGENET_FIXTURE) as f:
        pixels = f["pixels"]
        bufs = [f[f"jpeg_{i}"].tobytes() for i in range(len(pixels))]
    if out["jpeg"]:
        cy = np.full(len(bufs), -1.0, np.float32)
        got, status = nativelib.decode_jpeg_batch(
            bufs, 0, pixels.shape[1], pixels.shape[2], cy, cy,
            np.zeros(len(bufs), np.uint8), 2)
        out["native_jpeg_status"] = status.tolist()
        out["native_jpeg_mean_abs_diff"] = float(np.abs(
            got.transpose(0, 2, 3, 1).astype(int) - pixels.astype(int))
            .mean())
    if image_mod._BACKEND == "cv2":
        got = np.stack([image_mod._decode(b) for b in bufs])
        out["cv2_jpeg_mean_abs_diff"] = float(
            np.abs(got.astype(int) - pixels.astype(int)).mean())
    # the built-in codec on this machine: the same PNG batch (no random
    # draws) through it and through the chain's first tier, bit for bit
    batches = {}
    for backend in ("numpy", image_mod._BACKEND):
        saved = image_mod._BACKEND
        image_mod._BACKEND = backend
        try:
            with mx.cpu(0):
                it = mx.io.ImageRecordIter(
                    path_imgrec=rec, data_shape=(3, cfg["image"],
                                                 cfg["image"]),
                    batch_size=cfg["batch"], scale=1.0 / 255)
                batches[backend] = it.next().data[0].asnumpy()
                it.close()
        finally:
            image_mod._BACKEND = saved
    out["builtin_codec_equal"] = bool(np.array_equal(
        batches["numpy"], batches[image_mod._BACKEND]))
    return out


def _imagenet_aug(torch, mx, tmp):
    """(c): one ImageIter and one ImageDetIter batch under the augmenter
    lists, on the card and on the host from the same seeds."""
    import random
    from mxnet_tpu_torch import recordio
    from mxnet_tpu_torch.image import image as image_mod
    cfg = IMAGENET_AUG
    rng = np.random.RandomState(1)
    cls_path = os.path.join(tmp, "aug.rec")
    det_path = os.path.join(tmp, "det.rec")
    w = recordio.MXIndexedRecordIO(os.path.join(tmp, "aug.idx"), cls_path,
                                   "w")
    dw = recordio.MXRecordIO(det_path, "w")
    for i in range(cfg["records"]):
        img = rng.randint(0, 255, (cfg["image"], cfg["image"], 3), np.uint8)
        png = image_mod._png_encode(img)
        w.write_idx(i, recordio.pack(recordio.IRHeader(0, float(i % 4), i,
                                                       0), png))
        box = np.sort(rng.rand(4)).astype(np.float32)
        lab = np.array([2.0, 5.0, float(i % 3), box[0], box[1], box[2],
                        box[3]], np.float32)
        dw.write(recordio.pack(recordio.IRHeader(0, lab, i, 0), png))
    w.close()
    dw.close()
    shape = (3, cfg["crop"], cfg["crop"])

    def cls_iter():
        return mx.image.ImageIter(
            batch_size=cfg["batch"], data_shape=shape, path_imgrec=cls_path,
            aug_list=mx.image.CreateAugmenter(
                shape, rand_crop=True, rand_mirror=True, mean=True, std=True,
                brightness=0.2, contrast=0.2, saturation=0.2,
                pca_noise=0.1))

    def det_iter():
        return mx.image.ImageDetIter(
            batch_size=cfg["batch"], data_shape=shape, path_imgrec=det_path,
            aug_list=mx.image.CreateDetAugmenter(
                shape, rand_crop=0.5, rand_pad=0.5, rand_mirror=True,
                mean=True, std=True, brightness=0.2, contrast=0.2,
                saturation=0.2))

    def first_batch(make):
        random.seed(0)
        np.random.seed(0)
        return make().next()

    def warm(make):
        # a long run's trace loses the records at its head: a batch of
        # the same iterator and 64 small kernels, not counted
        first_batch(make)
        for _ in range(64):
            torch.ones(1, device="cuda").add_(1)

    rows = {}
    for name, make in (("ImageIter", cls_iter), ("ImageDetIter", det_iter)):
        got = {}
        for where in ("card", "host"):
            if where == "card":
                with mx.gpu(0), _profiled(
                        torch, warm=functools.partial(warm, make),
                        where=f"imagenet {name}") as prof:
                    batch = first_batch(make)
                    torch.cuda.synchronize()
                copies = _copies(torch, prof)
            else:
                with mx.cpu(0):
                    batch = first_batch(make)
            got[where] = (batch.data[0].asnumpy(), batch.label[0].asnumpy(),
                          batch.data[0].data_torch.device.type,
                          batch.label[0].data_torch.device.type)
        rows[name] = dict(
            equal=bool(np.array_equal(got["card"][0], got["host"][0])
                       and np.array_equal(got["card"][1], got["host"][1])),
            card_devices=list(got["card"][2:]),
            host_devices=list(got["host"][2:]),
            copies=copies, data_shape=list(got["card"][0].shape),
            label_shape=list(got["card"][1].shape))
    return rows


def phase_imagenet(torch, model_zoo_step_ms=None):
    """``imagenet``: ``train_imagenet.py``'s RecordIO pipeline into
    ResNet-50 on the card (module comment above ``IMAGENET``)."""
    import mxnet_tpu_torch as mx
    cfg = IMAGENET
    t0 = time.perf_counter()
    tmp = tempfile.mkdtemp(prefix="mxnet-imagenet-")
    try:
        prefix = os.path.join(tmp, "synth_imagenet")
        _synth_rec(prefix, cfg["records"], cfg["image"], cfg["classes"])
        rec = prefix + ".rec"
        synth_s = time.perf_counter() - t0
        native = _imagenet_native(mx, rec, cfg)
        # the example's AMP path (bfloat16), then the same recipe in
        # float32, which holds the example's learning criterion
        train, first = _imagenet_train(torch, mx, rec, cfg)
        train32, _ = _imagenet_train(torch, mx, rec, dict(cfg, dtype=None))
        host_equal, host_devices = _imagenet_host_batches(mx, rec, cfg,
                                                          first)
        producer = _imagenet_producer(mx, rec, cfg)
        aug = _imagenet_aug(torch, mx, tmp)
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    _free(torch)
    emit("imagenet", train=train, train_float32=train32,
         host_batches_equal=host_equal,
         host_devices=host_devices, producer_ms_per_batch=producer,
         native=native, augmenters=aug,
         model_zoo_fixed_batch_step_ms=model_zoo_step_ms,
         synth_seconds=synth_s, seconds=time.perf_counter() - t0)
    # the learning criterion holds the float32 run: the bfloat16
    # trajectory is chaotic (ROADMAP 6.7), so its losses are only
    # required to be finite
    losses = train32["losses"]
    check(all(np.isfinite(losses)) and losses[-1] <= 0.9 * losses[0]
          and train32["accuracy"] >= 0.5,
          f"imagenet: float32 did not learn the synthetic classes (losses "
          f"{losses[0]} -> {losses[-1]}, accuracy {train32['accuracy']})")
    check(all(np.isfinite(train["losses"])),
          f"imagenet: bfloat16 losses {train['losses']}")
    check(all(host_equal) and host_devices == ["cpu"],
          f"imagenet: card batches vs mx.cpu(0)'s {host_equal} "
          f"{host_devices}")
    for run in (train, train32):
        check(run["devices"] == ["cuda"],
              f"imagenet {run['dtype']}: batches on {run['devices']}")
        check(run["copies_per_step"]["HtoD"] == 2
              and run["copies_per_step"]["DtoH"] == 1,
              f"imagenet {run['dtype']}: copies a traced step "
              f"{run['copies_per_step']} (want 2 to the card, 1 back)")
        check(run["programs"] == 1,
              f"imagenet {run['dtype']}: {run['programs']} step programs")
    check(native["jpeg"] == CARD_HAS_LIBJPEG
          and native["cv2"] == CARD_HAS_CV2 and native["pil"] == CARD_HAS_PIL,
          f"imagenet: this machine's decode tiers {native} differ from "
          f"the probe's (libjpeg {CARD_HAS_LIBJPEG}, cv2 {CARD_HAS_CV2}, "
          f"PIL {CARD_HAS_PIL})")
    check(native["records_equal"] and native["csv_equal"]
          and native["builtin_codec_equal"],
          f"imagenet: native library or codec tiers {native}")
    if CARD_HAS_LIBJPEG:
        check(not any(native["native_jpeg_status"])
              and native["native_jpeg_mean_abs_diff"] < IMAGENET_JPEG_TOL,
              f"imagenet: native JPEG decode {native}")
    if "cv2_jpeg_mean_abs_diff" in native:
        check(native["cv2_jpeg_mean_abs_diff"] < IMAGENET_JPEG_TOL,
              f"imagenet: cv2 JPEG decode {native}")
    for name, row in aug.items():
        check(row["equal"] and row["card_devices"] == ["cuda", "cuda"]
              and row["host_devices"] == ["cpu", "cpu"]
              and row["copies"]["HtoD"] == 2,
              f"imagenet: {name} {row}")


# ---------------------------------------------------------------- ops_card
# Every op of the op library's long tail (160 names), on the card and on
# the port's CPU over the same seeded inputs (the table below: the card
# has no JAX, so the CPU port, held to the JAX package by
# tests/test_torch_op_sweep.py, is the reference here).  Forward: integer, index and quantized outputs
# bit for bit; float32 (TF32 off) within rtol 1e-5, atol 1e-6; the
# decompositions within 1e-4 of the output's max (syevd's eigenvector
# rows up to sign).  Differentiable ops: the gradient of
# sum_i sum(out_i * cot_i) with respect to the float inputs within 1e-4
# of the host gradient's max.  The samplers by their moments on the
# card; the RNN op at examples/word_language_model.py's widths.
OPS_CARD_NEW = 160             # names of the long tail (Custom waits)
OPS_CARD_RTOL, OPS_CARD_ATOL = 1e-5, 1e-6
OPS_CARD_FACTOR_TOL = 1e-4     # of the output's max
OPS_CARD_GRAD_TOL = 1e-4       # of the host gradient's max
OPS_CARD_FACTORS = ("_linalg_gelqf", "_linalg_syevd", "_linalg_potrf",
                    "_linalg_potri", "_linalg_inverse", "_linalg_det",
                    "_linalg_slogdet")
# examples/word_language_model.py: embed 64, hidden 128, 2 LSTM layers,
# batch 16, bptt 20
OPS_CARD_RNN = dict(T=20, N=16, I=64, H=128, layers=2)
OPS_CARD_DRAWS = 200000


def _r32(r, *s):
    return r.randn(*s).astype(np.float32)


def _pos32(r, *s):
    return (np.abs(r.randn(*s)) + 0.3).astype(np.float32)


def _i8(r, *s):
    return np.clip(r.randn(*s) * 50, -127, 127).astype(np.int8)


def _spd32(r, n, batch=()):
    m = r.randn(*batch, n, n)
    return (m @ np.swapaxes(m, -1, -2) + n * np.eye(n)).astype(np.float32)


def _mm():
    return [np.array([-1.0], np.float32), np.array([1.0], np.float32)]


def _ssd_label(r, B, M):
    lab = np.zeros((B, M, 5), np.float32)
    for b in range(B):
        for m in range(M):
            x0, y0 = r.uniform(0, 0.6, 2)
            w, h = r.uniform(0.1, 0.4, 2)
            lab[b, m] = [r.randint(0, 3) if m < M - 1 else -1, x0, y0,
                         x0 + w, y0 + h]
    return lab


def _ops_card_specs():
    """name -> (inputs(rng), kwargs, indices of the inputs to
    differentiate or None for every float one)."""
    N = 8 * 8 * 4
    return {
        # detection (SSD's shapes: 8x8 cells, 4 anchors, 3 classes)
        "_contrib_MultiBoxPrior": (lambda r: [_r32(r, 2, 4, 8, 8)],
                                   dict(sizes=(0.3, 0.45),
                                        ratios=(1.0, 2.0, 0.5)), None),
        "_contrib_MultiBoxTarget": (
            lambda r: [np.sort(r.rand(1, N, 2, 2), axis=2).transpose(
                0, 1, 3, 2).reshape(1, N, 4).astype(np.float32),
                _ssd_label(r, 4, 3), r.rand(4, 3, N).astype(np.float32)],
            dict(negative_mining_ratio=3.0), None),
        "_contrib_MultiBoxDetection": (
            lambda r: [r.dirichlet(np.ones(3), (4, N)).transpose(0, 2, 1)
                       .astype(np.float32), _r32(r, 4, N * 4) * 0.5,
                       np.sort(r.rand(1, N, 2, 2), axis=2).transpose(
                           0, 1, 3, 2).reshape(1, N, 4).astype(np.float32)],
            dict(nms_threshold=0.45), None),
        # contrib
        "_contrib_div_sqrt_dim": (lambda r: [_r32(r, 4, 8, 64)], {}, None),
        "_contrib_interleaved_matmul_selfatt_qk": (
            lambda r: [_r32(r, 16, 4, 4 * 3 * 32)], dict(heads=4), None),
        "_contrib_interleaved_matmul_selfatt_valatt": (
            lambda r: [_r32(r, 16, 4, 4 * 3 * 32), _pos32(r, 16, 16, 16)],
            dict(heads=4), None),
        "_contrib_interleaved_matmul_encdec_qk": (
            lambda r: [_r32(r, 12, 4, 4 * 32), _r32(r, 16, 4, 4 * 2 * 32)],
            dict(heads=4), None),
        "_contrib_interleaved_matmul_encdec_valatt": (
            lambda r: [_r32(r, 16, 4, 4 * 2 * 32), _pos32(r, 16, 12, 16)],
            dict(heads=4), None),
        "_contrib_AdaptiveAvgPooling2D": (
            lambda r: [_r32(r, 2, 8, 14, 14)], dict(output_size=(5, 3)),
            None),
        "_contrib_BilinearResize2D": (
            lambda r: [_r32(r, 2, 8, 12, 12)], dict(height=20, width=7,
                                                    align_corners=False),
            None),
        "_contrib_ROIAlign": (
            lambda r: [_r32(r, 2, 8, 16, 16),
                       np.array([[0, 1.5, 2.0, 9.0, 12.5],
                                 [1, 0.0, 0.0, 15.0, 15.0],
                                 [0, 4.2, 3.3, 6.1, 11.0]], np.float32)],
            dict(pooled_size=(4, 4), sample_ratio=2), [0]),
        "_contrib_index_copy": (
            lambda r: [_r32(r, 16, 8), np.array([3, 0, 11], np.float32),
                       _r32(r, 3, 8)], {}, [0, 2]),
        "_contrib_index_array": (lambda r: [_r32(r, 3, 4, 5)],
                                 dict(axes=(0, 2)), None),
        "smooth_l1": (lambda r: [_r32(r, 8, 64)], dict(scalar=1.0), None),
        # tensor
        "rcbrt": (lambda r: [_r32(r, 8, 64)], {}, None),
        "gamma": (lambda r: [_pos32(r, 8, 64) * 3], {}, None),
        "shape_array": (lambda r: [_r32(r, 3, 4, 5)], {}, None),
        "size_array": (lambda r: [_r32(r, 3, 4, 5)], {}, None),
        "make_loss": (lambda r: [_r32(r, 8, 16)], {}, None),
        "_hypot_scalar": (lambda r: [_r32(r, 8, 16)], dict(scalar=1.5),
                          None),
        "_greater_scalar_rev": (lambda r: [_r32(r, 8, 16)],
                                dict(scalar=0.25), None),
        "nansum": (lambda r: [np.where(r.rand(8, 16) < 0.2, np.nan,
                                       _r32(r, 8, 16)).astype(np.float32)],
                   dict(axis=1), None),
        "nanprod": (lambda r: [np.where(r.rand(8, 16) < 0.2, np.nan,
                                        _pos32(r, 8, 16)).astype(
                                            np.float32)],
                    dict(axis=0), None),
        "argmax_channel": (lambda r: [_r32(r, 8, 16)], {}, None),
        "khatri_rao": (lambda r: [_r32(r, 4, 6), _r32(r, 5, 6),
                                  _r32(r, 3, 6)], {}, None),
        "depth_to_space": (lambda r: [_r32(r, 2, 16, 5, 5)],
                           dict(block_size=2), None),
        "space_to_depth": (lambda r: [_r32(r, 2, 4, 8, 8)],
                           dict(block_size=2), None),
        "diag": (lambda r: [_r32(r, 6, 7)], dict(k=1), None),
        "gather_nd": (lambda r: [_r32(r, 6, 7, 3),
                                 np.array([[0, 5, 2, 3], [1, 6, 0, 4]],
                                          np.float32)], {}, [0]),
        "scatter_nd": (lambda r: [_r32(r, 5, 3),
                                  np.array([[0, 2, 2, 1, 0]], np.float32)],
                       dict(shape=(4, 3)), [0]),
        "sequence_mask": (lambda r: [_r32(r, 10, 4, 6),
                                     np.array([3, 10, 1, 7], np.float32)],
                          dict(use_sequence_length=True, value=-1.0), [0]),
        "sequence_last": (lambda r: [_r32(r, 10, 4, 6),
                                     np.array([3, 10, 1, 7], np.float32)],
                          dict(use_sequence_length=True), [0]),
        "sequence_reverse": (lambda r: [_r32(r, 10, 4, 6),
                                        np.array([3, 10, 1, 7],
                                                 np.float32)],
                             dict(use_sequence_length=True), [0]),
        "boolean_mask": (lambda r: [_r32(r, 12, 5),
                                    (r.rand(12) > 0.5).astype(np.float32)],
                         {}, None),
        "_zeros": (lambda r: [], dict(shape=(3, 5)), None),
        "_ones": (lambda r: [], dict(shape=(3, 5), dtype="int32"), None),
        "_full": (lambda r: [], dict(shape=(3, 5), value=2.5), None),
        "_arange": (lambda r: [], dict(start=1, stop=20, step=1.5,
                                       repeat=2), None),
        "_linspace": (lambda r: [], dict(start=-1, stop=3, num=17), None),
        "_eye": (lambda r: [], dict(N=5, M=7, k=1), None),
        "_contrib_arange_like": (lambda r: [_r32(r, 4, 6)],
                                 dict(start=1.0, step=0.5), None),
        "amp_cast": (lambda r: [_r32(r, 8, 16)], dict(dtype="float16"),
                     None),
        "amp_multicast": (lambda r: [_r32(r, 8, 16).astype(np.float16),
                                     _r32(r, 16)], dict(num_outputs=2),
                          None),
        "all_finite": (lambda r: [_r32(r, 8, 16), _r32(r, 5)], {}, None),
        "cumsum": (lambda r: [_r32(r, 8, 16)], dict(axis=1), None),
        "cumprod": (lambda r: [_pos32(r, 4, 6)], {}, None),
        "digamma": (lambda r: [_pos32(r, 8, 16) * 4], {}, None),
        "unravel_index": (lambda r: [np.array([0, 5, 17, 59], np.float32)],
                          dict(shape=(3, 4, 5)), None),
        "split_v2": (lambda r: [_r32(r, 12, 6)],
                     dict(indices_or_sections=(2, 7), axis=0), None),
        "Crop": (lambda r: [_r32(r, 2, 3, 12, 12), _r32(r, 1, 1, 8, 6)],
                 dict(center_crop=True, num_args=2), [0]),
        # nn
        "softmin": (lambda r: [_r32(r, 8, 16)], {}, None),
        "SoftmaxActivation": (lambda r: [_r32(r, 4, 6, 5)],
                              dict(mode="channel"), None),
        "L2Normalization": (lambda r: [_r32(r, 4, 6, 5)], {}, None),
        "LRN": (lambda r: [_r32(r, 2, 8, 6, 6)], dict(nsize=5), None),
        "UpSampling": (lambda r: [_r32(r, 2, 4, 5, 5)],
                       dict(scale=2, sample_type="bilinear", num_args=1),
                       None),
        "BilinearSampler": (lambda r: [_r32(r, 2, 4, 8, 8),
                                       np.clip(_r32(r, 2, 2, 6, 6) * 0.6,
                                               -0.99, 0.99)], {}, None),
        "Correlation": (lambda r: [_r32(r, 2, 8, 12, 12),
                                   _r32(r, 2, 8, 12, 12)],
                        dict(kernel_size=3, max_displacement=2, stride1=1,
                             stride2=1, pad_size=3), None),
        "GridGenerator": (lambda r: [_r32(r, 2, 6)],
                          dict(target_shape=(6, 7)), None),
        "hard_sigmoid": (lambda r: [_r32(r, 8, 16) * 3], {}, None),
        "im2col": (lambda r: [_r32(r, 2, 4, 9, 9)],
                   dict(kernel=(3, 3), stride=(2, 2), pad=(1, 1)), None),
        "col2im": (lambda r: [_r32(r, 2, 36, 25)],
                   dict(output_size=(9, 9), kernel=(3, 3), stride=(2, 2),
                        pad=(1, 1)), None),
        # a dyadic theta and grid (5 x 9 points on [-1, 1]): every
        # grid coordinate is exact, so the comparison reads the sampler,
        # not the last bit of linspace (XLA's and torch's round apart)
        "SpatialTransformer": (
            lambda r: [_r32(r, 2, 4, 9, 9),
                       np.array([[0.875, 0.125, 0.0625, -0.125, 1.125,
                                  0.0]] * 2, np.float32)],
            dict(target_shape=(5, 9)), None),
        "ROIPooling": (lambda r: [_r32(r, 2, 4, 12, 12),
                                  np.array([[0, 1, 1, 8, 9],
                                            [1, 0, 3, 11, 11]],
                                           np.float32)],
                       dict(pooled_size=(3, 3), spatial_scale=1.0), [0]),
        "RNN": (lambda r: [_r32(r, 5, 3, 6) * 0.5,
                           (r.rand(2 * (3 * 8 * 6 + 3 * 8 * 8 + 6 * 8)
                                   + 2 * (3 * 8 * 16 + 3 * 8 * 8 + 6 * 8))
                            - 0.5).astype(np.float32) * 0.5,
                           _r32(r, 4, 3, 8) * 0.1],
                dict(state_size=8, num_layers=2, mode="gru",
                     bidirectional=True, state_outputs=True), None),
        # linalg
        "_linalg_gemm": (lambda r: [_r32(r, 3, 4, 5), _r32(r, 3, 6, 5),
                                    _r32(r, 3, 4, 6)],
                         dict(transpose_b=True, alpha=0.5, beta=2.0), None),
        "_linalg_gemm2": (lambda r: [_r32(r, 3, 5, 4), _r32(r, 3, 5, 6)],
                          dict(transpose_a=True), None),
        "_linalg_potrf": (lambda r: [_spd32(r, 6, (2,))], {}, None),
        "_linalg_potri": (lambda r: [np.linalg.cholesky(
            _spd32(r, 6, (2,))).astype(np.float32)], {}, None),
        "_linalg_trsm": (lambda r: [np.tril(_spd32(r, 5)), _r32(r, 4, 5)],
                         dict(rightside=True, alpha=2.0), None),
        "_linalg_trmm": (lambda r: [np.tril(_spd32(r, 5)), _r32(r, 5, 4)],
                         dict(transpose=True), None),
        "_linalg_syrk": (lambda r: [_r32(r, 2, 4, 6)], dict(alpha=0.5),
                         None),
        "_linalg_sumlogdiag": (lambda r: [_spd32(r, 5, (2,))], {}, None),
        "_linalg_extractdiag": (lambda r: [_r32(r, 2, 5, 5)],
                                dict(offset=-1), None),
        "_linalg_makediag": (lambda r: [_r32(r, 2, 5)], dict(offset=1),
                             None),
        "_linalg_det": (lambda r: [_spd32(r, 5, (2,))], {}, None),
        "_linalg_slogdet": (lambda r: [_r32(r, 2, 5, 5)], {}, None),
        "_linalg_inverse": (lambda r: [_spd32(r, 5, (2,))], {}, None),
        "_linalg_gelqf": (lambda r: [_r32(r, 4, 7)], {}, None),
        "_linalg_syevd": (lambda r: [_spd32(r, 6)], {}, None),
        # quantization (int32 / int8 outputs bit for bit)
        "_contrib_quantize": (lambda r: [_r32(r, 8, 32)] + _mm(), {}, None),
        "_contrib_quantize_v2": (lambda r: [_r32(r, 8, 32)], {}, None),
        "_contrib_dequantize": (lambda r: [_i8(r, 8, 32)] + _mm(), {},
                                None),
        "_contrib_requantize": (
            lambda r: [(r.randn(8, 32) * 1e6).astype(np.int32)] + _mm(),
            {}, None),
        "_contrib_quantized_fully_connected": (
            lambda r: [_i8(r, 16, 512), _i8(r, 64, 512),
                       _i8(r, 64)] + _mm() * 3,
            dict(num_hidden=64), None),
        "_contrib_quantized_conv": (
            lambda r: [_i8(r, 2, 16, 12, 12), _i8(r, 32, 16, 3, 3),
                       _i8(r, 32)] + _mm() * 3,
            dict(kernel=(3, 3), pad=(1, 1), num_filter=32), None),
        "_contrib_quantized_pooling": (
            lambda r: [_i8(r, 2, 4, 9, 9)] + _mm(),
            dict(kernel=(3, 3), stride=(2, 2), pad=(1, 1),
                 pool_type="avg"), None),
        "_contrib_quantized_flatten": (lambda r: [_i8(r, 2, 3, 4)] + _mm(),
                                       {}, None),
        "_contrib_quantized_act": (lambda r: [_i8(r, 8, 16)] + _mm(), {},
                                   None),
        # MoE, LARS
        "_contrib_moe_top1_dispatch": (lambda r: [_r32(r, 32, 4)],
                                       dict(capacity_factor=1.5), None),
        "_contrib_moe_ffn": (
            lambda r: [_r32(r, 2, 16, 8), _r32(r, 8, 4),
                       _r32(r, 4, 8, 16) * 0.3, _r32(r, 4, 16) * 0.1,
                       _r32(r, 4, 16, 8) * 0.3, _r32(r, 4, 8) * 0.1],
            {}, None),
        "_contrib_multi_lars": (lambda r: [_pos32(r, 6), _pos32(r, 6),
                                           _pos32(r, 6), _pos32(r, 6) * 0.1],
                                dict(eta=0.01), None),
    }


# samplers: kwargs of a draw of OPS_CARD_DRAWS on the card, and its mean
# and variance (zipfian's from its formula)
def _ops_card_samplers():
    zipf = np.floor(np.exp(np.linspace(0, 1, 2000001)[:-1] * np.log(50)))
    zipf = np.clip(zipf - 1, 0, 49)
    return {
        "_random_uniform": (dict(low=-1.0, high=3.0), 1.0, 16 / 12),
        "_random_normal": (dict(loc=0.5, scale=2.0), 0.5, 4.0),
        "_random_gamma": (dict(alpha=2.5, beta=1.5), 3.75, 5.625),
        "_random_exponential": (dict(lam=2.0), 0.5, 0.25),
        "_random_poisson": (dict(lam=3.5), 3.5, 3.5),
        "_random_randint": (dict(low=-3, high=7), 1.5, 99 / 12),
        "_random_negative_binomial": (dict(k=3, p=0.4), 4.5, 11.25),
        "_sample_unique_zipfian": (dict(range_max=50), float(zipf.mean()),
                                   float(zipf.var())),
    }


# samplers checked by their own draws in phase_ops_card
OPS_CARD_OTHER_SAMPLERS = ("_sample_multinomial", "_shuffle",
                           "sample_uniform", "sample_normal")


def _ops_card_names(registry):
    """Every registered name (aliases too) whose op the phase runs."""
    ops = set(_ops_card_specs()) | set(_ops_card_samplers()) \
        | set(OPS_CARD_OTHER_SAMPLERS)
    return [n for n in registry.list_ops() if registry.get_op(n).name in ops]


def _ops_card_run(torch, mx, name, arrays, kwargs, wrt, dev, cots=None):
    """``name``'s registered function on ``dev``: (outputs as host
    numpy, gradients of sum(out_i * cot_i) w.r.t. ``wrt`` as host numpy
    or None, the cotangents)."""
    from mxnet_tpu_torch.ops import registry
    op = registry.get_op(name)
    ctx = mx.gpu(0) if dev.type == "cuda" else mx.cpu(0)
    ts = [torch.tensor(a, device=dev) for a in arrays]
    if wrt is None:
        wrt = [i for i, a in enumerate(arrays)
               if np.issubdtype(a.dtype, np.floating)]
    diff = op.differentiable and bool(wrt)
    for i in wrt if diff else ():
        ts[i].requires_grad_(True)
    with ctx, torch.enable_grad():
        outs = op.fn(*ts, **kwargs)
        outs = list(outs) if isinstance(outs, (list, tuple)) else [outs]
        grads = None
        floats = [i for i, o in enumerate(outs) if o.is_floating_point()
                  and o.requires_grad]
        if diff and floats:
            if cots is None:
                r = np.random.RandomState(len(name))
                cots = {i: np.asarray(r.randn(*outs[i].shape), np.float32)
                        for i in floats}
            scalar = sum((outs[i].float() * torch.tensor(
                cots[i], device=dev)).sum() for i in floats)
            got = torch.autograd.grad(scalar, [ts[i] for i in wrt],
                                      allow_unused=True)
            grads = [np.zeros(arrays[i].shape, np.float32) if g is None
                     else g.detach().cpu().numpy()
                     for i, g in zip(wrt, got)]
    return [o.detach().cpu().numpy() for o in outs], grads, cots


def _ops_card_err(name, i, got, want):
    """(error, limit) of one output on the card against the host."""
    if got.shape != want.shape or got.dtype != want.dtype:
        return float("inf"), 0.0
    if not np.issubdtype(want.dtype, np.floating):
        return float(np.count_nonzero(got != want)), 0.0
    g, w = got.astype(np.float64), want.astype(np.float64)
    if name in OPS_CARD_FACTORS:
        if name == "_linalg_syevd" and i == 0:
            s = np.sign(np.sum(g * w, axis=-1, keepdims=True))
            g = g * np.where(s == 0, 1, s)
        return float(np.abs(g - w).max()), \
            OPS_CARD_FACTOR_TOL * float(np.abs(w).max())
    # the worst element's excess over rtol |want| + atol, as a ratio
    lim = OPS_CARD_ATOL + OPS_CARD_RTOL * np.abs(w)
    diff = np.where(np.isnan(w) & np.isnan(g), 0.0, np.abs(g - w))
    return float((diff / lim).max()) if g.size else 0.0, 1.0


def _ops_card_capture(torch, mx, dev):
    """A sampler captured in a CUDA graph draws anew at every replay,
    and boolean_mask refuses to be captured."""
    from mxnet_tpu_torch.base import MXNetError
    from mxnet_tpu_torch.ops import registry
    out = {}
    stream = torch.cuda.Stream()
    for name, kwargs in (("_random_normal", dict(shape=(4096,))),
                         ("_sample_multinomial", {})):
        fn = registry.get_op(name).fn
        probs = torch.tensor([[0.1, 0.2, 0.3, 0.4]] * 4096, device=dev)
        args = [probs] if name == "_sample_multinomial" else []
        g = torch.cuda.CUDAGraph()
        with mx.gpu(0):
            stream.wait_stream(torch.cuda.current_stream())
            with torch.cuda.stream(stream):
                fn(*args, **kwargs)             # warm-up
                torch.cuda.synchronize()
                with torch.cuda.graph(g, stream=stream):
                    static = fn(*args, **kwargs)
            torch.cuda.current_stream().wait_stream(stream)
        g.replay()
        a = static.clone()
        g.replay()
        b = static.clone()
        torch.cuda.synchronize()
        out[name] = dict(differ=bool((a != b).any()),
                         mean=float(b.float().mean()))
    mask_err = None
    g = torch.cuda.CUDAGraph()
    data = torch.ones(8, 3, device=dev)
    index = torch.ones(8, device=dev)
    try:
        with torch.cuda.stream(stream):
            with torch.cuda.graph(g, stream=stream):
                mx.nd.boolean_mask(mx.nd.NDArray._wrap(data),
                                   mx.nd.NDArray._wrap(index))
    except MXNetError as e:
        mask_err = str(e)
    except Exception as e:              # the graph rejected the sync
        mask_err = f"{type(e).__name__}: {e}"
    torch.cuda.synchronize()
    out["boolean_mask_under_capture"] = mask_err
    return out


def phase_ops_card(torch, dev):
    """``ops_card``: every op of the long tail on the card against
    the port's CPU (module comment above ``OPS_CARD_NEW``), the samplers'
    moments on the card, a captured sampler replayed twice, boolean_mask
    under capture, and the RNN op at the word language model's widths."""
    import mxnet_tpu_torch as mx
    from mxnet_tpu_torch.ops import registry
    t0 = time.perf_counter()
    host = torch.device("cpu")
    specs = _ops_card_specs()
    samplers = _ops_card_samplers()
    covered = _ops_card_names(registry)
    failures, worst = [], {}
    for name, (make, kwargs, wrt) in sorted(specs.items()):
        arrays = make(np.random.RandomState(len(name) * 7 + 1))
        want, want_g, cots = _ops_card_run(torch, mx, name, arrays, kwargs,
                                           wrt, host)
        got, got_g, _ = _ops_card_run(torch, mx, name, arrays, kwargs, wrt,
                                      dev, cots)
        if name == "_linalg_syevd":
            # eigenvector rows come with either sign: the card's gradient
            # is taken against the cotangent flipped with its rows
            flip = np.sign(np.sum(got[0] * want[0], axis=-1, keepdims=True))
            got, got_g, _ = _ops_card_run(
                torch, mx, name, arrays, kwargs, wrt, dev,
                {**cots, 0: (cots[0] * np.where(flip == 0, 1, flip))
                 .astype(np.float32)})
        errs = [_ops_card_err(name, i, g, w)
                for i, (g, w) in enumerate(zip(got, want))]
        if len(got) != len(want):
            errs.append((float("inf"), 0.0))
        if want_g is not None:
            for g, w in zip(got_g or [], want_g):
                errs.append((float(np.abs(g - w).max()),
                             OPS_CARD_GRAD_TOL * float(np.abs(w).max())))
        worst[name] = max(e / lim if lim else (0.0 if e == 0 else np.inf)
                          for e, lim in errs)
        if worst[name] > 1.0:
            failures.append((name, errs))
    moments = {}
    for name, (kwargs, mean, var) in samplers.items():
        with mx.gpu(0):
            x = registry.get_op(name).fn(shape=(OPS_CARD_DRAWS,), **kwargs)
        x = x.double()
        m, v = float(x.mean()), float(x.var())
        se = np.sqrt(var / OPS_CARD_DRAWS)
        moments[name] = dict(device=str(x.device), mean=m, want_mean=mean,
                             var=v, want_var=var,
                             mean_z=abs(m - mean) / se)
    probs = torch.tensor([[0.1, 0.2, 0.3, 0.4]], device=dev)
    draws = registry.get_op("_sample_multinomial").fn(
        probs, shape=(OPS_CARD_DRAWS,))
    freq = torch.bincount(draws.reshape(-1).long(), minlength=4).double() \
        / OPS_CARD_DRAWS
    moments["_sample_multinomial"] = dict(
        device=str(draws.device), freq=freq.tolist(),
        want=[0.1, 0.2, 0.3, 0.4])
    rows = torch.arange(1000, device=dev, dtype=torch.float32)
    perm = registry.get_op("_shuffle").fn(rows)
    shuffle_ok = bool((torch.sort(perm).values == rows).all()) \
        and float((perm != rows).float().mean()) > 0.9
    lo = torch.full((1,), -1.0, device=dev)
    u = registry.get_op("sample_uniform").fn(lo, lo + 3.0,
                                             shape=(OPS_CARD_DRAWS,))
    z = registry.get_op("sample_normal").fn(lo + 2.0, lo + 1.5,
                                            shape=(OPS_CARD_DRAWS,))
    moments["sample_uniform"] = dict(mean=float(u.mean()), want_mean=0.5,
                                     min=float(u.min()), max=float(u.max()))
    moments["sample_normal"] = dict(mean=float(z.mean()), want_mean=1.0,
                                    std=float(z.std()), want_std=0.5)
    captured = _ops_card_capture(torch, mx, dev)
    # the RNN op at the word language model's widths
    cfg = OPS_CARD_RNN
    r = np.random.RandomState(11)
    I, H, L = cfg["I"], cfg["H"], cfg["layers"]
    n_params = sum(4 * H * (I if l == 0 else H) + 4 * H * H + 8 * H
                   for l in range(L))
    arrays = [r.randn(cfg["T"], cfg["N"], I).astype(np.float32) * 0.5,
              (r.rand(n_params).astype(np.float32) - 0.5) * 0.2,
              r.randn(L, cfg["N"], H).astype(np.float32) * 0.1,
              r.randn(L, cfg["N"], H).astype(np.float32) * 0.1]
    kw = dict(state_size=H, num_layers=L, mode="lstm", state_outputs=True)
    want, want_g, cots = _ops_card_run(torch, mx, "RNN", arrays, kw, [1],
                                       host)
    t_rnn = time.perf_counter()
    got, got_g, _ = _ops_card_run(torch, mx, "RNN", arrays, kw, [1], dev,
                                  cots)
    rnn_ms = (time.perf_counter() - t_rnn) * 1e3
    rnn_err = max(_ops_card_err("RNN", i, g, w)[0]
                  for i, (g, w) in enumerate(zip(got, want)))
    rnn_grad_err = float(np.abs(got_g[0] - want_g[0]).max()
                         / np.abs(want_g[0]).max())
    seconds = time.perf_counter() - t0
    emit("ops_card", names=len(covered),
         ops=len(specs) + len(samplers) + len(OPS_CARD_OTHER_SAMPLERS),
         worst_err_over_limit=worst, failures=[f[0] for f in failures],
         failure_errors={f[0]: f[1] for f in failures},
         samplers=moments, shuffle_permutes=shuffle_ok, captured=captured,
         rnn=dict(**cfg, params=n_params, max_err_over_limit=rnn_err,
                  param_grad_rel_err=rnn_grad_err,
                  card_ms_with_host=rnn_ms),
         seconds=seconds)
    check(len(covered) == OPS_CARD_NEW,
          f"ops_card: the table covers {len(covered)} names, "
          f"want {OPS_CARD_NEW}")
    check(not failures, f"ops_card: card vs host beyond the limits: "
          f"{[(n, e) for n, e in failures]}")
    for name, mo in moments.items():
        if "mean_z" in mo:
            check(mo["device"].startswith("cuda") and mo["mean_z"] < 5
                  and abs(mo["var"] - mo["want_var"]) < 0.05 * mo["want_var"],
                  f"ops_card: {name}'s moments on the card {mo}")
    check(np.abs(np.array(moments["_sample_multinomial"]["freq"])
                 - np.array([0.1, 0.2, 0.3, 0.4])).max() < 0.01,
          f"ops_card: multinomial frequencies {moments['_sample_multinomial']}")
    check(shuffle_ok, "ops_card: _shuffle did not permute the rows")
    check(abs(moments["sample_uniform"]["mean"] - 0.5) < 0.02
          and moments["sample_uniform"]["min"] >= -1.0
          and moments["sample_uniform"]["max"] < 2.0
          and abs(moments["sample_normal"]["mean"] - 1.0) < 0.01
          and abs(moments["sample_normal"]["std"] - 0.5) < 0.01,
          f"ops_card: per-element samplers {moments['sample_uniform']} "
          f"{moments['sample_normal']}")
    check(all(captured[n]["differ"] for n in ("_random_normal",
                                              "_sample_multinomial")),
          f"ops_card: a captured sampler replayed the same draw {captured}")
    check(captured["boolean_mask_under_capture"] is not None
          and "boolean_mask" in captured["boolean_mask_under_capture"],
          f"ops_card: boolean_mask under capture: {captured}")
    check(rnn_err <= 1.0 and rnn_grad_err <= OPS_CARD_GRAD_TOL,
          f"ops_card: the RNN op at word-LM widths, forward "
          f"{rnn_err} of the limit, parameter gradient {rnn_grad_err}")


# -------------------------------------------------------------- bert_squad
# (a) examples/bert_squad.py's own recipe at its defaults (the example
# imports jax, so this is its loop over the port): a from-scratch BERT of
# vocab 64, units 128, 2 layers, 4 heads, hidden 512 with BERTForQA,
# batch 32 of synthetic [CLS] q [SEP] passage [SEP] episodes, 1500 steps
# of SpanLoss hybridized with static_alloc, AdamW at 1e-3, wd 0.01 under
# PolyScheduler with warm-up, held to the example's convergence gate on
# 256 held-out episodes.  (b) BERT-large SQuAD fine-tuning: the Gluon
# bert_24_1024_16 (Devlin et al. 2019) + BERTForQA with use_flash=True at
# L 384, the max_seq_length of Google's run_squad.py, batch 8 with ragged
# valid lengths, AdamW at run_squad.py's 3e-5, wd 0.01, fp32 with TF32
# off, dropout 0 (the example's); 2 eager steps, then 10 steps of the
# three-call recipe hybridized (one CUDA graph a step).  The first loss,
# at batch 2 x L 128 from the same weights, is held to the port on the
# host; at the path's own B 8 x L 384 ragged batch, one eager step of the
# flash path is held to the dense additive-mask path from the same
# weights (loss and every gradient); the first hybridized loss is held to
# the eager loss from the same state.  No real SQuAD data: seeded
# episodes of the example's form.
SQUAD_EXAMPLE = dict(vocab=64, units=128, layers=2, heads=4, hidden=512,
                     batch=32, steps=1500, lr=1e-3, wd=0.01, q_len=8,
                     p_len=48, ans_len=4, eval_every=50, eval_batch=64,
                     final_batch=256, min_em=0.9)
SQUAD_LARGE = dict(vocab=30522, max_length=512, L=384, B=8, q_len=64,
                   ans_len=4, valid=(384, 371, 330, 301, 288, 257, 200, 129),
                   host_L=128, host_valid=(128, 101), lr=3e-5, wd=0.01,
                   eager_steps=2, steps=10, traced_steps=3, em_reps=5)
SQUAD_HOST_RTOL = 1e-4          # first loss, card vs host, relative
# (b)'s flash path against the dense additive-mask path at B 8 x L 384:
# the loss relative, each gradient of its own dense max|g|; a gradient
# nought up to rounding (its dense max|g| at most SQUAD_NOUGHT of the
# model's largest: the span classifier's bias and the last LayerNorm's
# beta, which a shift of every position leaves unchanged, and the unused
# pooler) is held to SQUAD_PARITY_GRAD_TOL of the model's largest
SQUAD_PARITY_LOSS_RTOL = 1e-5
SQUAD_PARITY_GRAD_TOL = 1e-4
SQUAD_NOUGHT = 1e-5
SQUAD_FIRST_RTOL = 1e-5         # first hybridized loss vs the eager one


PAGED_NAMES = ("ragged_paged_attention", "ragged_paged_verify")


def _kernel_counts(zero=False):
    """Every kernel wrapper's launch count, B1-B5 (zeroed first with
    ``zero``)."""
    from mxnet_tpu_torch.ops import paged_attention as pa
    counters = _flash_counters() + (pa.ragged_paged_attention,
                                    pa.ragged_paged_verify)
    if zero:
        for c in counters:
            c.launches = 0
    return {c.__name__: c.launches for c in counters}


def _squad_batch(rng, B, vocab, q_len, p_len, ans_len):
    """examples/bert_squad.py's ``make_batch`` in numpy: [CLS] q [SEP]
    passage [SEP], the answer span after a marker token in the passage
    and copied into the question; (tokens, segments, valid lengths,
    starts, ends)."""
    cls, sep, mark = 1, 2, 3
    L = 1 + q_len + 1 + p_len + 1
    toks = np.zeros((B, L), np.int32)
    segs = np.zeros((B, L), np.int32)
    starts = np.zeros((B,), np.int32)
    ends = np.zeros((B,), np.int32)
    for b in range(B):
        passage = rng.randint(4, vocab, p_len)
        s = rng.randint(1, p_len - ans_len)
        passage[s - 1] = mark
        q = np.zeros(q_len, np.int32)
        q[:ans_len] = passage[s:s + ans_len]
        toks[b] = np.concatenate([[cls], q, [sep], passage, [sep]])
        p_off = 1 + q_len + 1
        segs[b, p_off:] = 1
        starts[b] = p_off + s
        ends[b] = p_off + s + ans_len - 1
    return toks, segs, np.full((B,), L, np.float32), starts, ends


def _squad_ragged(rng, valid, L, vocab, q_len, ans_len):
    """Episodes of the example's form padded to ``L``, row ``b`` holding
    ``valid[b]`` tokens (its passage that much shorter)."""
    rows = [_squad_batch(rng, 1, vocab, q_len, v - q_len - 3, ans_len)
            for v in valid]
    toks = np.zeros((len(valid), L), np.int32)
    segs = np.zeros((len(valid), L), np.int32)
    for b, (t, s, _v, _s, _e) in enumerate(rows):
        toks[b, :t.shape[1]] = t[0]
        segs[b, :s.shape[1]] = s[0]
    return (toks, segs, np.asarray(valid, np.float32),
            np.concatenate([r[3] for r in rows]),
            np.concatenate([r[4] for r in rows]))


def _nd_batch(mx, arrays):
    return tuple(mx.nd.array(a, dtype="int32") if a.dtype == np.int32
                 else mx.nd.array(a) for a in arrays)


def _span_loss(mx, qa_net):
    """examples/bert_squad.py's ``SpanLoss`` over the port: the QA head
    and the start / end softmax cross entropy in one HybridBlock."""
    class SpanLoss(mx.gluon.HybridBlock):
        def __init__(self, qa, **kwargs):
            super().__init__(**kwargs)
            with self.name_scope():
                self.qa = qa

        def hybrid_forward(self, F, toks, segs, vlen, starts, ends):
            scores = self.qa(toks, segs, vlen)              # (B, L, 2)
            start_logits = F.squeeze(
                F.slice_axis(scores, axis=2, begin=0, end=1), axis=2)
            end_logits = F.squeeze(
                F.slice_axis(scores, axis=2, begin=1, end=2), axis=2)
            l1 = F.pick(F.log_softmax(start_logits), starts, axis=1)
            l2 = F.pick(F.log_softmax(end_logits), ends, axis=1)
            return -0.5 * (F.mean(l1) + F.mean(l2))

    return SpanLoss(qa_net)


def _squad_em(mx, qa_net, batch):
    """The example's exact-match: the arg-max start and end both right."""
    toks, segs, vlen, starts, ends = batch
    with mx.autograd.pause(train_mode=False):
        scores = qa_net(toks, segs, vlen).asnumpy()
    return float(np.mean((scores[:, :, 0].argmax(axis=1) == starts.asnumpy())
                         & (scores[:, :, 1].argmax(axis=1)
                            == ends.asnumpy())))


def _squad_example(torch, mx):
    """(a): the example's loop; returns its readings."""
    cfg = SQUAD_EXAMPLE
    mx.random.seed(0)
    rng = np.random.RandomState(0)
    shape = (cfg["vocab"], cfg["q_len"], cfg["p_len"], cfg["ans_len"])
    with mx.gpu(0):
        bert = mx.models.get_bert_model(
            "bert_12_768_12", vocab_size=cfg["vocab"], units=cfg["units"],
            hidden_size=cfg["hidden"], num_layers=cfg["layers"],
            num_heads=cfg["heads"], max_length=128, dropout=0.0)
        bert.initialize(mx.init.Normal(0.02))
        qa = mx.models.BERTForQA(bert)
        qa.initialize(mx.init.Normal(0.02))
        step_blk = _span_loss(mx, qa)
        step_blk.hybridize(static_alloc=True)
        sched = mx.lr_scheduler.PolyScheduler(
            max_update=cfg["steps"], base_lr=cfg["lr"], pwr=1,
            final_lr=cfg["lr"] / 5, warmup_steps=max(1, cfg["steps"] // 20))
        trainer = mx.gluon.Trainer(qa.collect_params(), "adamw",
                                   {"learning_rate": cfg["lr"],
                                    "lr_scheduler": sched, "wd": cfg["wd"]})
        losses, ems = [], []
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for step in range(1, cfg["steps"] + 1):
            batch = _nd_batch(mx, _squad_batch(rng, cfg["batch"], *shape))
            with mx.autograd.record():
                loss = step_blk(*batch)
            loss.backward()
            trainer.step(cfg["batch"])
            if step % cfg["eval_every"] == 0 or step == 1:
                losses.append(float(loss.asnumpy()))
                ems.append(_squad_em(mx, qa, _nd_batch(mx, _squad_batch(
                    rng, cfg["eval_batch"], *shape))))
        torch.cuda.synchronize()
        train_s = time.perf_counter() - t0
        em = _squad_em(mx, qa, _nd_batch(mx, _squad_batch(
            rng, cfg["final_batch"], *shape)))
        programs = step_blk._cached_op.stats()["programs"]
    return dict(steps=cfg["steps"], train_s=train_s,
                ms_per_step=train_s / cfg["steps"] * 1e3,
                losses_every_50=losses, em_every_50=ems, final_em=em,
                cached_programs=programs)


def _squad_large_host_check(mx, qa):
    """The first loss at batch 2 x L 128 on the card and on the host from
    the card's weights (both eager): (card, host)."""
    cfg = SQUAD_LARGE
    arrays = _squad_ragged(np.random.RandomState(1), cfg["host_valid"],
                           cfg["host_L"], cfg["vocab"], 16, cfg["ans_len"])
    with mx.gpu(0), mx.autograd.record():
        card = float(_span_loss(mx, qa)(*_nd_batch(mx, arrays)).asnumpy())
    with mx.cpu(0):
        host = mx.models.BERTForQA(mx.models.bert_24_1024_16(
            vocab_size=cfg["vocab"], dropout=0.0, use_flash=True))
        host.initialize()
        weights = qa._collect_params_with_prefix()
        for name, p in host._collect_params_with_prefix().items():
            p.set_data(weights[name].data())
        with mx.autograd.record():
            loss = _span_loss(mx, host)(*_nd_batch(mx, arrays))
        return [card, float(loss.asnumpy())]


def _squad_large_parity(mx, qa, batch):
    """(b)'s flash path (B1-B3) against the dense additive-mask path at
    the path's own shapes: one eager SpanLoss forward and backward of
    each from ``qa``'s weights on (b)'s ragged batch.  Returns the two
    losses, each gradient's error over its own dense max|g| (over the
    model's largest |g| for a gradient nought up to rounding) and those
    gradients' dense max|g| over the model's largest."""
    cfg = SQUAD_LARGE
    dense = mx.models.BERTForQA(mx.models.bert_24_1024_16(
        vocab_size=cfg["vocab"], dropout=0.0, use_flash=False))
    dense.initialize()
    weights = qa._collect_params_with_prefix()
    for name, p in dense._collect_params_with_prefix().items():
        p.set_data(weights[name].data())
    losses, grads = {}, {}
    for tag, net in (("flash", qa), ("dense", dense)):
        with mx.autograd.record():
            loss = _span_loss(mx, net)(*batch)
        loss.backward()
        losses[tag] = float(loss.asnumpy())
        grads[tag] = {n: p.grad().data_torch
                      for n, p in net._collect_params_with_prefix().items()
                      if p.grad_req != "null"}
    own = {n: float(g.abs().max()) for n, g in grads["dense"].items()}
    scale = max(own.values())
    nought = {n: m / scale for n, m in own.items()
              if m <= SQUAD_NOUGHT * scale}
    errs = {n: float((grads["flash"][n] - g).abs().max())
            / (scale if n in nought else own[n])
            for n, g in grads["dense"].items()}
    return losses, errs, nought


def phase_bert_squad(torch):
    """``bert_squad``: (a) the SQuAD example's recipe, (b) BERT-large
    SQuAD fine-tuning (module comment above ``SQUAD_EXAMPLE``).  Returns
    B1-B3's wrapper launches on (b)'s path and their records in its
    traced steps."""
    import mxnet_tpu_torch as mx
    example = _squad_example(torch, mx)
    _free(torch)
    cfg = SQUAD_LARGE
    rng = np.random.RandomState(0)
    arrays = _squad_ragged(rng, cfg["valid"], cfg["L"], cfg["vocab"],
                           cfg["q_len"], cfg["ans_len"])
    mx.random.seed(0)
    with mx.gpu(0):
        bert = mx.models.bert_24_1024_16(vocab_size=cfg["vocab"],
                                         dropout=0.0, use_flash=True)
        qa = mx.models.BERTForQA(bert)
        qa.initialize(mx.init.Normal(0.02))
        host_losses = _squad_large_host_check(mx, qa)
        _free(torch)
        batch = _nd_batch(mx, arrays)
        parity_losses, grad_errs, nought = _squad_large_parity(mx, qa, batch)
        _free(torch)
        step_blk = _span_loss(mx, qa)
        trainer = mx.gluon.Trainer(qa.collect_params(), "adamw",
                                   {"learning_rate": cfg["lr"],
                                    "wd": cfg["wd"]})
        step = _gluon_stepper(mx, trainer, batch, block=step_blk)
        _kernel_counts(zero=True)
        eager_losses, eager_ms = _gluon_loop(step, cfg["eager_steps"],
                                             sync=torch.cuda.synchronize)
        eager_launches = _kernel_counts()
        # the eager loss from the state the first hybridized step starts
        # from
        with mx.autograd.record():
            eager_loss = float(step_blk(*batch).asnumpy())
        step_blk.hybridize(static_alloc=True)
        _kernel_counts(zero=True)
        losses, ms = _gluon_loop(step, cfg["steps"],
                                 sync=torch.cuda.synchronize)
        launches = _kernel_counts()
        ms_per_step = float(np.median(ms[2:]))
        trace = _trace_steps(torch, step, cfg["traced_steps"], ms_per_step,
                             warm=step, where="bert_squad",
                             names=FLASH_NAMES)
        graph_launches = TRACE_LAUNCHES[-1]["counted"]
        em_ms = []
        for _ in range(cfg["em_reps"] + 1):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            em = _squad_em(mx, qa, batch)
            em_ms.append((time.perf_counter() - t0) * 1e3)
        memory = dict(allocated=torch.cuda.memory_allocated(),
                      peak=torch.cuda.max_memory_allocated())
        del step, trainer, step_blk, qa, bert, batch
    _free(torch)
    host_rel = abs(host_losses[0] - host_losses[1]) / abs(host_losses[1])
    parity_rel = abs(parity_losses["flash"] - parity_losses["dense"]) \
        / abs(parity_losses["dense"])
    worst = max((e, n) for n, e in grad_errs.items())
    first_rel = abs(losses[0] - eager_loss) / abs(eager_loss)
    layers = 24
    emit("bert_squad", example=example,
         model="bert_24_1024_16 + BERTForQA, use_flash", L=cfg["L"],
         B=cfg["B"], valid=list(cfg["valid"]), optimizer="adamw",
         lr=cfg["lr"], dtype="float32",
         first_loss_card_host=host_losses, first_loss_rel_err=host_rel,
         first_loss_rtol=SQUAD_HOST_RTOL,
         parity=dict(losses=parity_losses, loss_rel_err=parity_rel,
                     worst_grad_err=worst[0], worst_grad_tensor=worst[1],
                     grad_tensors=len(grad_errs),
                     nought_max_over_largest=nought,
                     nought_errs={n: grad_errs[n] for n in nought}),
         eager_loss_before_hybridize=eager_loss,
         first_hybrid_rel_err=first_rel, eager_losses=eager_losses,
         eager_ms=eager_ms, losses=losses, step_ms=ms,
         ms_per_step=ms_per_step,
         samples_per_s=cfg["B"] / ms_per_step * 1e3,
         launches_eager=eager_launches, launches=launches,
         graph_launches_per_traced_step=len(graph_launches)
         / cfg["traced_steps"], trace=trace,
         em_forward_ms=float(np.median(em_ms[1:])), em_first_ms=em_ms[0],
         em=em, memory=memory)
    check(example["final_em"] >= SQUAD_EXAMPLE["min_em"],
          f"bert_squad: the example's exact-match {example['final_em']} "
          f"below {SQUAD_EXAMPLE['min_em']}")
    check(host_rel <= SQUAD_HOST_RTOL,
          f"bert_squad: first loss {host_losses} (card, host), {host_rel} "
          f"relative")
    check(parity_rel <= SQUAD_PARITY_LOSS_RTOL,
          f"bert_squad: flash loss {parity_losses['flash']} vs dense "
          f"{parity_losses['dense']} at L {cfg['L']}, {parity_rel} relative")
    check(worst[0] <= SQUAD_PARITY_GRAD_TOL,
          f"bert_squad: flash gradient of {worst[1]} off the dense one by "
          f"{worst[0]} of its max (nought up to rounding: {nought})")
    check(first_rel <= SQUAD_FIRST_RTOL,
          f"bert_squad: first hybridized loss {losses[0]} vs the eager "
          f"{eager_loss}, {first_rel} relative")
    check(all(np.isfinite(eager_losses + losses)),
          f"bert_squad: losses {eager_losses + losses}")
    check(eager_launches == {**dict.fromkeys(FLASH_NAMES,
                                             layers * cfg["eager_steps"]),
                             **dict.fromkeys(PAGED_NAMES, 0)},
          f"bert_squad: eager kernel launches {eager_launches}")
    check(launches == {**dict.fromkeys(FLASH_NAMES, 2 * layers),
                       **dict.fromkeys(PAGED_NAMES, 0)},
          f"bert_squad: hybridized B1-B3 wrapper launches {launches}, want "
          f"{2 * layers} each (the signature's first call and the full "
          f"step's eager warm-up)")
    check(trace["records_per_step"] == dict.fromkeys(FLASH_NAMES,
                                                     float(layers))
          and len(graph_launches) == cfg["traced_steps"],
          f"bert_squad: {trace['records_per_step']} B1-B3 records and "
          f"{len(graph_launches)} graph launches in {cfg['traced_steps']} "
          f"traced steps")
    return dict(launches=launches,
                traced={k: v * cfg["traced_steps"]
                        for k, v in trace["records_per_step"].items()})



# --------------------------------------------------------------------- nmt
# (a) examples/nmt_transformer.py's own recipe at its defaults (the
# example imports jax): the reversal-with-shift corpus of 3000 pairs,
# transformer_base at vocab 24, units 64, hidden 256, 2 + 2 layers, 4
# heads, hybridize(bucket_shapes=...), SmoothedSoftmaxCELoss, Adam at
# 3e-3 with its per-epoch decay, 14 epochs of batch 32, then the beam
# search (beam 4) on the 64 held-out sentences, held to the example's
# --min-match 0.9 and, token for token, to beam_search_host.
# (b) transformer-big (Vaswani et al. 2017: units 1024, hidden 4096, 6 + 6
# layers, 16 heads) with a 32768-token shared vocabulary and tied
# embeddings (the 32K joint BPE of Ott et al. 2018, "Scaling NMT"),
# dropout 0.1, fp32: 2 eager + 10 hybridized Adam steps at batch 32, source
# and target bucket 64 (ragged lengths inside); then the beam search at
# B 32, beam 4, Ls 64, max_decode_len 64, alpha 0.6 (one CUDA graph a
# decode step) against the same step run eagerly (graphs=False), and at
# max_decode_len 8 on 2 sentences against beam_search_host (reported
# only: random weights make near-ties).  No WMT data: seeded tokens.
NMT_EXAMPLE = dict(vocab=24, units=64, layers=2, heads=4, pairs=3000,
                   test=64, min_len=3, max_len=10, epochs=14, batch=32,
                   lr=3e-3, beam=4, min_match=0.9)
NMT_BIG = dict(vocab=32768, B=32, Ls=64, Lt=64, dropout=0.1, lr=1e-4,
               eager_steps=2, steps=10, traced_steps=3, beam=4,
               max_decode_len=64, alpha=0.6, searches=3, host_B=2,
               host_len=8, eos=1)
# The searches end on id 1, a token no label of the training batch holds:
# 12 steps on random tokens teach the model one preference, the batch's
# EOS 3 (the one id that every row holds), and with it every beam ends
# within 4 steps; with id 1 no beam finishes early and each search runs
# its 64 decode steps.


def _nmt_pairs(n, vocab, min_len, max_len, rng):
    """The example's corpus: the target is the reversed source with a +1
    vocabulary rotation."""
    pairs = []
    for _ in range(n):
        L = rng.randint(min_len, max_len + 1)
        src = rng.randint(4, vocab, (L,)).astype(np.int32)
        tgt = ((src[::-1] - 4 + 1) % (vocab - 4)) + 4
        pairs.append((src, tgt.astype(np.int32)))
    return pairs


def _nmt_buckets(max_len):
    return tuple(range(4, max_len + 8, 4))


def _nmt_batches(pairs, batch_size, max_len, rng):
    """The example's padded, length-bucketed batches (numpy)."""
    bks = _nmt_buckets(max_len)
    order = rng.permutation(len(pairs))
    window = 8 * batch_size
    for w0 in range(0, len(order), window):
        idx = sorted(order[w0:w0 + window], key=lambda i: len(pairs[i][0]))
        for b0 in range(0, len(idx), batch_size):
            chunk = [pairs[i] for i in idx[b0:b0 + batch_size]]
            if len(chunk) < batch_size:
                continue
            Ls = min(b for b in bks if b >= max(len(s) for s, _ in chunk))
            Lt = min(b for b in bks
                     if b >= max(len(t) for _, t in chunk) + 1)
            src = np.zeros((batch_size, Ls), np.int32)
            tgt_in = np.zeros((batch_size, Lt), np.int32)
            tgt_out = np.zeros((batch_size, Lt), np.int32)
            sv = np.zeros((batch_size,), np.float32)
            tv = np.zeros((batch_size,), np.float32)
            for i, (s, t) in enumerate(chunk):
                src[i, :len(s)] = s
                tgt_in[i, 0] = 2
                tgt_in[i, 1:len(t) + 1] = t
                tgt_out[i, :len(t)] = t
                tgt_out[i, len(t)] = 3
                sv[i], tv[i] = len(s), len(t) + 1
            yield src, tgt_in, tgt_out, sv, tv


def _nmt_hyp(row):
    hyp = []
    for tok in row[1:]:
        if tok == 3:
            break
        hyp.append(int(tok))
    return hyp


def _nmt_example(torch, mx):
    """(a): the example's loop and its beam decode; returns readings."""
    cfg = NMT_EXAMPLE
    mx.random.seed(0)
    rng = np.random.RandomState(0)
    train = _nmt_pairs(cfg["pairs"], cfg["vocab"], cfg["min_len"],
                       cfg["max_len"], rng)
    test = _nmt_pairs(cfg["test"], cfg["vocab"], cfg["min_len"],
                      cfg["max_len"], rng)
    with mx.gpu(0):
        model = mx.models.transformer_base(
            src_vocab_size=cfg["vocab"], units=cfg["units"],
            hidden_size=4 * cfg["units"], num_layers=cfg["layers"],
            num_heads=cfg["heads"], dropout=0.0,
            max_length=cfg["max_len"] + 4)
        model.initialize(mx.init.Xavier())
        model.hybridize(bucket_shapes={1: list(_nmt_buckets(cfg["max_len"]))})
        loss_fn = mx.models.SmoothedSoftmaxCELoss(smoothing=0.1)
        trainer = mx.gluon.Trainer(model.collect_params(), "adam",
                                   {"learning_rate": cfg["lr"]})
        epoch_loss, steps = [], 0
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for epoch in range(cfg["epochs"]):
            trainer.set_learning_rate(cfg["lr"] / (1.0 + 0.35 * epoch) ** 0.5)
            total, n = 0.0, 0
            for arrays in _nmt_batches(train, cfg["batch"], cfg["max_len"],
                                       rng):
                src, tgt_in, tgt_out, sv, tv = _nd_batch(mx, arrays)
                with mx.autograd.record():
                    logits = model(src, tgt_in, sv, tv)
                    loss = loss_fn(logits, tgt_out, tv).mean()
                loss.backward()
                trainer.step(cfg["batch"])
                total += float(loss.asnumpy())
                n += 1
            epoch_loss.append(total / n)
            steps += n
        torch.cuda.synchronize()
        train_s = time.perf_counter() - t0
        group = {}
        for s, t in test:
            group.setdefault(len(s), []).append((s, t))
        correct, same, searches = 0, True, []
        t0 = time.perf_counter()
        outs = {}
        for L, items in sorted(group.items()):
            src = mx.nd.array(np.stack([s for s, _ in items]), dtype="int32")
            sv = mx.nd.array(np.full((len(items),), L, np.float32))
            outs[L] = (src, sv, model.beam_search(
                src, sv, bos=2, eos=3, beam_size=cfg["beam"],
                max_decode_len=cfg["max_len"] + 2).asnumpy())
            searches.append(dict(model._beam_decoder.last, L=L))
            correct += sum(_nmt_hyp(row) == list(t)
                           for row, (_s, t) in zip(outs[L][2], items))
        decode_s = time.perf_counter() - t0
        # the oracle decodes one growing prefix at a time: eagerly, not
        # a CUDA graph per prefix length
        model.hybridize(False)
        t0 = time.perf_counter()
        for L, (src, sv, out) in outs.items():
            for b in range(out.shape[0]):
                host = _beam_host_row(model, src, sv, b, bos=2, eos=3,
                                      beam_size=cfg["beam"],
                                      max_decode_len=cfg["max_len"] + 2)
                same &= list(out[b][:host.size]) == host.tolist()
        host_s = time.perf_counter() - t0
    return dict(epochs=cfg["epochs"], steps=steps, train_s=train_s,
                ms_per_step=train_s / steps * 1e3, epoch_loss=epoch_loss,
                beam_exact_match=correct / len(test), decode_s=decode_s,
                searches=searches, equals_beam_search_host=same,
                host_oracle_s=host_s)


def _nmt_big_batch(rng, cfg):
    B, Ls, Lt, V = cfg["B"], cfg["Ls"], cfg["Lt"], cfg["vocab"]
    sv = rng.randint(Ls // 2 + 1, Ls + 1, B).astype(np.float32)
    tv = rng.randint(Lt // 2 + 1, Lt + 1, B).astype(np.float32)
    src = rng.randint(4, V, (B, Ls)).astype(np.int32)
    tgt_in = rng.randint(4, V, (B, Lt)).astype(np.int32)
    tgt_in[:, 0] = 2
    tgt_out = np.roll(tgt_in, -1, axis=1)
    for b in range(B):
        src[b, int(sv[b]):] = 0
        tgt_in[b, int(tv[b]):] = 0
        tgt_out[b, int(tv[b]) - 1] = 3
        tgt_out[b, int(tv[b]):] = 0
    return src, tgt_in, tgt_out, sv, tv


def _beam_syncs(steps, max_len):
    """Host syncs of a search that ran ``steps`` decode steps: a read of
    ``finished`` every 4 steps short of ``max_len``, and the result's."""
    from mxnet_tpu_torch.models.decoding import CHECK_EVERY
    return sum(1 for n in range(1, steps + 1)
               if n % CHECK_EVERY == 0 and n < max_len) + 1


def _beam_host_row(model, src, sv, b, **kw):
    """``beam_search_host`` of sentence ``b`` alone: its rows end where
    each best beam ends, so sentences of a batch do not stack."""
    one = (src.slice_axis(axis=0, begin=b, end=b + 1),
           sv.slice_axis(axis=0, begin=b, end=b + 1))
    return model.beam_search_host(*one, **kw).asnumpy()[0]


def _first_diff(a, b):
    diff = np.argwhere(a != b)
    return None if diff.size == 0 else [int(i) for i in diff[0]]


def phase_nmt(torch):
    """``nmt``: (a) the NMT example's recipe, (b) transformer-big training
    and beam search (module comment above ``NMT_EXAMPLE``)."""
    import mxnet_tpu_torch as mx
    from mxnet_tpu_torch.models.decoding import TransformerBeamDecoder
    example = _nmt_example(torch, mx)
    _free(torch)
    cfg = NMT_BIG
    rng = np.random.RandomState(0)
    arrays = _nmt_big_batch(rng, cfg)
    mx.random.seed(0)
    with mx.gpu(0):
        model = mx.models.transformer_big(cfg["vocab"], tie_weights=True,
                                          dropout=cfg["dropout"])
        model.initialize(mx.init.Xavier())
        src, tgt_in, tgt_out, sv, tv = _nd_batch(mx, arrays)
        loss_fn = mx.models.SmoothedSoftmaxCELoss(smoothing=0.1)
        trainer = mx.gluon.Trainer(model.collect_params(), "adam",
                                   {"learning_rate": cfg["lr"]})

        def step():
            with mx.autograd.record():
                loss = loss_fn(model(src, tgt_in, sv, tv), tgt_out,
                               tv).mean()
            loss.backward()
            trainer.step(cfg["B"])
            return loss

        _kernel_counts(zero=True)
        eager_losses, eager_ms = _gluon_loop(step, cfg["eager_steps"],
                                             sync=torch.cuda.synchronize)
        model.hybridize(static_alloc=True)
        losses, ms = _gluon_loop(step, cfg["steps"],
                                 sync=torch.cuda.synchronize)
        ms_per_step = float(np.median(ms[2:]))
        trace = _trace_steps(torch, step, cfg["traced_steps"], ms_per_step,
                             warm=step, where="nmt_train")
        graph_launches = TRACE_LAUNCHES[-1]["counted"]
        del trainer
        _free(torch)
        kw = dict(bos=2, eos=cfg["eos"], beam_size=cfg["beam"],
                  max_decode_len=cfg["max_decode_len"], alpha=cfg["alpha"])
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        first = model.beam_search(src, sv, **kw).asnumpy()
        first_s = time.perf_counter() - t0
        dec = model._beam_decoder
        prog = next(iter(dec._progs.values()))
        search_ms, lasts = [], []
        for _ in range(cfg["searches"]):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            ids = model.beam_search(src, sv, **kw).asnumpy()
            search_ms.append((time.perf_counter() - t0) * 1e3)
            lasts.append(dict(dec.last))
        search_trace = _trace_steps(
            torch, lambda: model.beam_search(src, sv, **kw), 1,
            float(np.median(search_ms)),
            warm=lambda: model.beam_search(src, sv, **kw), where="nmt_beam")
        search_launches = TRACE_LAUNCHES[-1]["counted"]
        eager_dec = TransformerBeamDecoder(model, graphs=False)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        eager_ids = eager_dec(src, sv, **kw).asnumpy()
        eager_search_ms = (time.perf_counter() - t0) * 1e3
        s2 = src.slice_axis(axis=0, begin=0, end=cfg["host_B"])
        v2 = sv.slice_axis(axis=0, begin=0, end=cfg["host_B"])
        kw8 = dict(kw, max_decode_len=cfg["host_len"])
        short = model.beam_search(s2, v2, **kw8).asnumpy()
        model.hybridize(False)
        host = [_beam_host_row(model, s2, v2, b, **kw8)
                for b in range(cfg["host_B"])]
        launches = _kernel_counts()
        # the step graph's pool: the segments it reserves (its own
        # memory pool, read from the allocator's snapshot)
        capture_s = prog.capture_s
        pool_bytes = _pool_reserved(torch, prog.pool)
        del model, dec, eager_dec, prog
    _free(torch)
    steps_taken = lasts[-1]["steps"]
    host_same = all(list(short[b][:h.size]) == h.tolist()
                    for b, h in enumerate(host))
    beam = dict(B=cfg["B"], beam=cfg["beam"], Ls=cfg["Ls"],
                max_decode_len=cfg["max_decode_len"], alpha=cfg["alpha"],
                first_search_s=first_s, ms_per_search=search_ms,
                ms_per_decode_step=float(np.median(search_ms)) / steps_taken,
                searches=lasts, capture_s=capture_s, pool_bytes=pool_bytes,
                trace=search_trace,
                device_ms_per_decode_step=(search_trace["device_ms_per_step"]
                                           or 0.0) / steps_taken,
                graph_launches_per_traced_search=len(search_launches),
                eager_ms_per_search=eager_search_ms,
                tokens_equal_eager=bool(np.array_equal(ids, eager_ids)),
                first_differing_position=_first_diff(ids, eager_ids),
                first_search_equal=bool(np.array_equal(first, ids)),
                host_oracle_len8_equal=host_same,
                host_oracle_len8=dict(graph=short.tolist(),
                                      host=[h.tolist() for h in host]))
    emit("nmt", example=example,
         model="transformer_big, vocab 32768 shared, tied embeddings",
         B=cfg["B"], Ls=cfg["Ls"], Lt=cfg["Lt"], dtype="float32",
         optimizer="adam", lr=cfg["lr"], eager_losses=eager_losses,
         eager_ms=eager_ms, losses=losses, step_ms=ms,
         ms_per_step=ms_per_step,
         target_tokens_per_s=float(arrays[4].sum()) / ms_per_step * 1e3,
         graph_launches_per_traced_step=len(graph_launches)
         / cfg["traced_steps"], trace=trace, beam=beam, launches=launches)
    check(example["beam_exact_match"] >= NMT_EXAMPLE["min_match"],
          f"nmt: the example's beam exact-match "
          f"{example['beam_exact_match']} below {NMT_EXAMPLE['min_match']}")
    check(example["equals_beam_search_host"],
          "nmt: the graph beam search differs from beam_search_host on "
          "the example's held-out sentences")
    check(all(np.isfinite(eager_losses + losses)),
          f"nmt: transformer-big losses {eager_losses + losses}")
    check(beam["tokens_equal_eager"] and beam["first_search_equal"],
          f"nmt: the graph beam search's tokens differ from the eager "
          f"step's at {beam['first_differing_position']}")
    check(all(s["replays"] == s["steps"] and s["eager_steps"] == 0
              and s["syncs"] == _beam_syncs(s["steps"],
                                            cfg["max_decode_len"])
              for s in lasts),
          f"nmt: searches {lasts}: want one replay a decode step and one "
          f"host sync a 4 steps")
    # the step graph's launches (the encoder's and the embedding's
    # CachedOp graphs launch once a search beside them)
    step_records, step_launches = collections.Counter(
        search_launches).most_common(1)[0]
    check(step_launches == steps_taken,
          f"nmt: {step_launches} launches of the {step_records}-record step "
          f"graph in a traced search of {steps_taken} decode steps "
          f"({search_launches})")
    check(launches == dict.fromkeys((*FLASH_NAMES, *PAGED_NAMES), 0),
          f"nmt: the NMT path launched kernels {launches}")
    return dict(launches=launches)


def _dtname(dtype):
    """A torch dtype's name without the ``torch.`` prefix."""
    return str(dtype).replace("torch.", "")


# --------------------------------------------------------------------- amp
# (a) examples/bert_squad.py's BERT-large + BERTForQA (flash, dropout 0,
# fp32 weights) at SQUAD_LARGE's B 8 x L 384 ragged batch under
# contrib.amp.init("bfloat16"): gluon.Trainer AdamW 3e-5 behind
# amp.init_trainer, the loss scaled by amp.scale_loss; 2 eager and 10
# hybridized steps.  The first AMP loss is held to the fp32 loss of the
# same weights, the first hybridized loss to the eager AMP loss from the
# same state; a traced step must hold 24 records each of the bf16
# (wgmma) B1 / B2 / B3 kernels; parameters and gradients stay float32; a
# forced overflow (a loss scale past float32's and bf16's range) must
# skip the step, the parameters bitwise unchanged and the scale halved.
# Then amp.init("float16") over gluon_mnist's LeNet: 10 steps of the
# scaler's real back-off and growth (scale 2^16, window 2), each skipped
# step's parameters bitwise unchanged, the first loss against the host's
# fp16 run; and over a flash encoder layer, which must raise KernelError
# (B1-B3 take fp32 and bf16 only).  amp._deinit() runs in a finally, and
# every model here is built after init and dropped before _deinit, so no
# CachedOp program crosses the switch.
AMP = dict(eager_steps=2, steps=10, traced_steps=3)
AMP_FP32_RTOL = 2e-2        # first AMP loss vs the fp32 loss, same weights
AMP_FIRST_RTOL = 1e-3       # first hybridized loss vs the eager AMP loss
AMP_OVERFLOW_SCALE = 2.0 ** 140   # past float32's (and bf16's) 3.4e38
# the bf16 kernels of B1-B3 (a traced step's records)
AMP_BF16_NAMES = {"flash_attention_fwd": "flash_fwd_wgmma",
                  "flash_attention_bwd_dq": "flash_bwd_dq_wgmma",
                  "flash_attention_bwd_dkv": "flash_bwd_dkv_wgmma"}
AMP_FP16 = dict(steps=10, init_scale=2.0 ** 16, window=2, batch=64,
                lr=1e-3)
# fp16 LeNet's first loss, card vs host: fp16 products accumulate in
# another order on each (cuDNN / the CPU's kernels), 2^-10 a rounding
AMP_FP16_HOST_RTOL = 1e-2


def _amp_step(mx, amp, trainer, block, batch, rows):
    """One AMP step of the loss block: record, ``scale_loss`` backward,
    ``trainer.step`` (the overflow check first, ``init_trainer``)."""
    def step():
        with mx.autograd.record():
            loss = block(*batch)
        with amp.scale_loss(loss, trainer) as scaled:
            scaled.backward()
        trainer.step(rows)
        return loss
    return step


def _count_host_reads(scaler):
    """Count the scaler's overflow reads (one host read each)."""
    reads = []
    real = scaler.has_overflow

    def counted(params):
        reads.append(1)
        return real(params)

    scaler.has_overflow = counted
    return reads


def _amp_bert(torch, mx, amp):
    """(a)'s BERT-large part (module comment above ``AMP``)."""
    cfg, big = AMP, SQUAD_LARGE
    rng = np.random.RandomState(0)
    arrays = _squad_ragged(rng, big["valid"], big["L"], big["vocab"],
                           big["q_len"], big["ans_len"])
    mx.random.seed(0)
    with mx.gpu(0):
        bert = mx.models.bert_24_1024_16(vocab_size=big["vocab"],
                                         dropout=0.0, use_flash=True)
        qa = mx.models.BERTForQA(bert)
        qa.initialize(mx.init.Normal(0.02))
        batch = _nd_batch(mx, arrays)
        step_blk = _span_loss(mx, qa)
        fp32_loss = float(step_blk(*batch).asnumpy())
        amp.init("bfloat16")
        trainer = mx.gluon.Trainer(qa.collect_params(), "adamw",
                                   {"learning_rate": big["lr"],
                                    "wd": big["wd"]})
        amp.init_trainer(trainer)
        scaler = trainer._amp_loss_scaler
        reads = _count_host_reads(scaler)
        step = _amp_step(mx, amp, trainer, step_blk, batch, big["B"])
        _kernel_counts(zero=True)
        eager_losses, eager_ms = _gluon_loop(step, cfg["eager_steps"],
                                             sync=torch.cuda.synchronize)
        eager_launches = _kernel_counts()
        params = [p for p in qa.collect_params().values()]
        dtypes = sorted({(_dtname(p.data()._data.dtype),
                          _dtname(p.grad()._data.dtype))
                         for p in params if p.grad_req != "null"})
        with mx.autograd.record():
            eager_loss = float(step_blk(*batch).asnumpy())
        step_blk.hybridize(static_alloc=True)
        _kernel_counts(zero=True)
        del reads[:]
        losses, ms = _gluon_loop(step, cfg["steps"],
                                 sync=torch.cuda.synchronize)
        launches = _kernel_counts()
        reads_per_step = len(reads) / cfg["steps"]
        ms_per_step = float(np.median(ms[2:]))
        trace = _trace_steps(torch, step, cfg["traced_steps"], ms_per_step,
                             warm=step, where="amp", names=AMP_BF16_NAMES)
        graph_launches = TRACE_LAUNCHES[-1]["counted"]
        # a forced overflow: the step is skipped
        before = {n: p.data()._data.clone()
                  for n, p in qa.collect_params().items()}
        skipped0 = scaler.stats["skipped"]
        scaler.loss_scale = AMP_OVERFLOW_SCALE
        step()
        torch.cuda.synchronize()
        changed = [n for n, p in qa.collect_params().items()
                   if not torch.equal(p.data()._data, before[n])]
        overflow = dict(scale_before=AMP_OVERFLOW_SCALE,
                        scale_after=scaler.loss_scale,
                        skipped=scaler.stats["skipped"] - skipped0,
                        params_changed=changed)
        del before, step, trainer, step_blk, qa, bert, batch
    return dict(fp32_loss=fp32_loss, eager_losses=eager_losses,
                eager_ms=eager_ms, eager_launches=eager_launches,
                eager_loss_before_hybridize=eager_loss, losses=losses,
                step_ms=ms, ms_per_step=ms_per_step, launches=launches,
                overflow_reads_per_step=reads_per_step, trace=trace,
                graph_launches=graph_launches, dtypes=dtypes,
                overflow=overflow)


def _amp_fp16_lenet(torch, mx, amp, ctx, path, x, y):
    """(a)'s fp16 LeNet run on ``ctx`` from the weights at ``path``: the
    scaler's sequence, skipped steps, losses."""
    cfg = AMP_FP16
    with ctx:
        net = _lenet(mx)
        net.load_parameters(path, ctx=ctx)
        trainer = mx.gluon.Trainer(net.collect_params(), "adam",
                                   {"learning_rate": cfg["lr"]})
        amp.init_trainer(trainer)
        scaler = trainer._amp_loss_scaler
        scaler.loss_scale = cfg["init_scale"]
        scaler._scale_window = cfg["window"]
        loss_fn = mx.gluon.loss.SoftmaxCrossEntropyLoss()
        xs, ys = mx.nd.array(x), mx.nd.array(y)
        scales, losses, skipped_unchanged, out_dtypes = [], [], [], set()
        for _ in range(cfg["steps"]):
            before = [p.data()._data.clone()
                      for p in net.collect_params().values()]
            skipped0 = scaler.stats["skipped"]
            with mx.autograd.record():
                out = net(xs)
                loss = loss_fn(out, ys)
            out_dtypes.add(_dtname(out._data.dtype))
            with amp.scale_loss(loss, trainer) as scaled:
                scaled.backward()
            trainer.step(x.shape[0])
            if scaler.stats["skipped"] > skipped0:
                skipped_unchanged.append(all(
                    torch.equal(p.data()._data, b) for p, b in zip(
                        net.collect_params().values(), before)))
            scales.append(scaler.loss_scale)
            losses.append(float(loss.mean().asscalar()))
        return dict(scales=scales, losses=losses,
                    skipped=scaler.stats["skipped"],
                    skipped_unchanged=skipped_unchanged,
                    output_dtypes=sorted(out_dtypes))


def _amp_fp16(torch, mx, amp):
    """(a)'s float16 part: LeNet on the card and the host, then the flash
    encoder layer's refusal."""
    cfg = AMP_FP16
    rs = np.random.RandomState(0)
    x = rs.rand(cfg["batch"], 1, 28, 28).astype(np.float32)
    y = rs.randint(0, 10, cfg["batch"]).astype(np.float32)
    tmp = tempfile.mkdtemp(prefix="mxnet-amp-")
    try:
        path = os.path.join(tmp, "lenet.npz")
        _lenet_weights(mx, path, x[:1])
        amp.init("float16")
        card = _amp_fp16_lenet(torch, mx, amp, mx.gpu(0), path, x, y)
        host = _amp_fp16_lenet(torch, mx, amp, mx.cpu(0), path, x, y)
        refused = None
        with mx.gpu(0):
            cfg_l = dict(GLUON_FLASH, L=128, B=2)
            layer = _encoder_layer(mx, cfg_l["units"], cfg_l["heads"],
                                   cfg_l["ffn"])
            layer.initialize(mx.init.Normal(0.02))
            xe, valid, _ye = _encoder_batch(cfg_l)
            try:
                layer(mx.nd.array(xe), mx.nd.array(valid))
                torch.cuda.synchronize()
            except mx.base.KernelError as e:
                refused = str(e)[:200]
            del layer
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    return dict(card=card, host=host, flash_refusal=refused,
                first_loss_rel_err=abs(card["losses"][0] - host["losses"][0])
                / abs(host["losses"][0]))


def phase_amp(torch):
    """``amp``: contrib.amp on the card (module comment above ``AMP``).
    Returns B1-B3's wrapper launches on the bf16 path and their bf16
    records in its traced steps."""
    import mxnet_tpu_torch as mx
    from mxnet_tpu_torch.contrib import amp
    t0 = time.perf_counter()
    try:
        bert = _amp_bert(torch, mx, amp)
        _free(torch)
        amp.amp._deinit()
        fp16 = _amp_fp16(torch, mx, amp)
    finally:
        amp.amp._deinit()
    _free(torch)
    cfg, layers = AMP, 24
    fp32_rel = abs(bert["eager_losses"][0] - bert["fp32_loss"]) \
        / abs(bert["fp32_loss"])
    first_rel = abs(bert["losses"][0] - bert["eager_loss_before_hybridize"]) \
        / abs(bert["eager_loss_before_hybridize"])
    trace, glaunch = bert["trace"], bert["graph_launches"]
    emit("amp", model="bert_24_1024_16 + BERTForQA, use_flash",
         target_dtype="bfloat16", L=SQUAD_LARGE["L"], B=SQUAD_LARGE["B"],
         optimizer="adamw", lr=SQUAD_LARGE["lr"],
         fp32_loss=bert["fp32_loss"], first_amp_loss_rel_err=fp32_rel,
         eager_losses=bert["eager_losses"], eager_ms=bert["eager_ms"],
         eager_loss_before_hybridize=bert["eager_loss_before_hybridize"],
         first_hybrid_rel_err=first_rel, losses=bert["losses"],
         step_ms=bert["step_ms"], ms_per_step=bert["ms_per_step"],
         param_grad_dtypes=bert["dtypes"],
         launches_eager=bert["eager_launches"], launches=bert["launches"],
         graph_launches_per_step=len(glaunch) / cfg["traced_steps"],
         records_per_graph_launch=glaunch,
         host_overflow_reads_per_step=bert["overflow_reads_per_step"],
         trace=trace, overflow=bert["overflow"], fp16=fp16,
         seconds=time.perf_counter() - t0)
    check(fp32_rel <= AMP_FP32_RTOL,
          f"amp: first AMP loss {bert['eager_losses'][0]} vs fp32 "
          f"{bert['fp32_loss']}, {fp32_rel} relative")
    check(first_rel <= AMP_FIRST_RTOL,
          f"amp: first hybridized loss {bert['losses'][0]} vs eager "
          f"{bert['eager_loss_before_hybridize']}, {first_rel} relative")
    alll = bert["eager_losses"] + bert["losses"]
    check(all(np.isfinite(alll)) and bert["losses"][-1] < alll[0],
          f"amp: losses {alll} (finite, falling)")
    check(bert["dtypes"] == [("float32", "float32")],
          f"amp: parameter / gradient dtypes {bert['dtypes']}")
    check(trace["records_per_step"] == dict.fromkeys(AMP_BF16_NAMES,
                                                     float(layers)),
          f"amp: bf16 B1-B3 records a traced step "
          f"{trace['records_per_step']}, want {layers} each")
    check(bert["overflow_reads_per_step"] == 1.0,
          f"amp: {bert['overflow_reads_per_step']} overflow reads a step")
    ov = bert["overflow"]
    check(not ov["params_changed"] and ov["skipped"] == 1
          and ov["scale_after"] == AMP_OVERFLOW_SCALE / 2,
          f"amp: forced overflow {ov}")
    seq = [AMP_FP16["init_scale"]] + fp16["card"]["scales"]
    check(fp16["card"]["skipped"] >= 1
          and all(fp16["card"]["skipped_unchanged"])
          and fp16["card"]["output_dtypes"] == ["float16"]
          and any(b < a for a, b in zip(seq, seq[1:]))
          and any(b > a for a, b in zip(seq, seq[1:])),
          f"amp: fp16 LeNet's scale must back off and grow: {fp16['card']}")
    check(fp16["first_loss_rel_err"] <= AMP_FP16_HOST_RTOL,
          f"amp: fp16 LeNet first loss card {fp16['card']['losses'][0]} vs "
          f"host {fp16['host']['losses'][0]}")
    check(fp16["flash_refusal"] is not None
          and "float32 or bfloat16" in fp16["flash_refusal"],
          f"amp: float16 through the flash layer was not refused "
          f"({fp16['flash_refusal']})")
    return dict(launches=bert["launches"],
                traced={k: v * cfg["traced_steps"]
                        for k, v in trace["records_per_step"].items()})


# ---------------------------------------------------------------- quantize
# (b) contrib.quantization on the card.  BERT-large as a Gluon
# BERTClassifier (bert_24_1024_16, flash, dropout 0, seed 0) at predict's
# shape, L 128 x batch 16: quantize_net with naive calibration over 4
# batches (the hooks copy every Dense input to the host), hybridized:
# each replay one CUDA graph holding 24 B1 records, its logits within
# QUANT_REPLAY_TOL of the int8 eager forward; the sequence output's
# correlation with fp32 and its max error; the int8 replay's device ms
# beside the fp32 Gluon replay's (and ``predict``'s bucket 16).  The
# same weights with dropout 0.1 through optimize_for(backend="inference"):
# no Dropout node, logits within QUANT_OPT_TOL of the block's eval
# forward, 24 B1 records a replay.  Then examples/quantize_int8.py's
# recipe (entropy, 4 batches), quantize_model over
# examples/lenet_symbol.py's symbol through Module, and two layers at
# BERT-large width quantized on the card against the host.
QUANT_NET = dict(L=128, B=16, calib_batches=4, replays=10, traced=3)
QUANT_REPLAY_TOL = 1e-5     # int8 replay vs int8 eager, of max|logit|
QUANT_OPT_TOL = 1e-5        # optimize_for's SymbolBlock vs the block
QUANT_MIN_CORR = 0.99       # int8 vs fp32 (tests/test_quantization.py)
QUANT_EXAMPLE = dict(batch=8, calib=4)
QUANT_HOST = dict(num_layers=2, B=4, L=128)


def _quant_inputs(rng, vocab, B, L):
    """A (B, 3, L) float array: token ids, token types (second half 1)
    and the valid length (16..L), one row a sample."""
    x = np.zeros((B, 3, L), np.float32)
    x[:, 0] = rng.randint(0, vocab, (B, L))
    x[:, 1, L // 2:] = 1
    x[:, 2] = rng.randint(16, L + 1, B)[:, None]
    return x


def _packed(mx, clf):
    """The classifier over one (B, 3, L) array (``_quant_inputs``), so
    that a calibration batch is one array, as quantize_net takes it."""
    class Packed(mx.gluon.HybridBlock):
        def __init__(self, **kw):
            super().__init__(**kw)
            with self.name_scope():
                self.clf = clf

        def hybrid_forward(self, F, x):
            return self.clf(*_unpack(F, x))

    return Packed(prefix="packed_")


def _unpack(F, x):
    ids = F.squeeze(F.slice_axis(x, axis=1, begin=0, end=1), axis=1)
    types = F.squeeze(F.slice_axis(x, axis=1, begin=1, end=2), axis=1)
    valid = F.reshape(F.slice_axis(F.slice_axis(
        x, axis=1, begin=2, end=3), axis=2, begin=0, end=1), shape=(-1,))
    return ids, types, valid


def _quant_classifier(mx, dropout, num_layers=24):
    bert = mx.models.get_bert_model("bert_24_1024_16", vocab_size=30522,
                                    dropout=dropout, use_flash=True,
                                    num_layers=num_layers)
    return mx.models.BERTClassifier(bert, num_classes=2, dropout=dropout)


def _cop_replay_ms(timer, block, iters):
    """Device ms of one replay of ``block``'s inference forward graph
    (its CachedOp's one signature) on the CachedOp's stream."""
    prog = next(iter(block._cached_op._cache.values()))
    with prog.graphs.on_stream():
        return timer(prog.infer.fwd.replay, iters=iters, warmup=2)


def _corr(a, b):
    return float(np.corrcoef(a.ravel(), b.ravel())[0, 1])


def _quant_bert(torch, mx, qt, timer, path):
    """(b)'s int8 BERT-large; the fp32 weights saved at ``path``."""
    cfg = QUANT_NET
    rng = np.random.RandomState(0)
    calib = [_quant_inputs(rng, 30522, cfg["B"], cfg["L"])
             for _ in range(cfg["calib_batches"])]
    x = _quant_inputs(rng, 30522, cfg["B"], cfg["L"])
    mx.random.seed(0)
    with mx.gpu(0):
        clf = _quant_classifier(mx, 0.0)
        clf.initialize(mx.init.Normal(0.02))
        net = _packed(mx, clf)
        X = mx.nd.array(x)
        logits32 = net(X).asnumpy()
        seq32 = clf.bert(*_unpack(mx.nd, X))[0].asnumpy()
        clf.save_parameters(path)
        net.hybridize(static_alloc=True)
        net(X)
        fp32_ms = _cop_replay_ms(timer, net, cfg["replays"])
        net.hybridize(False)
        _free(torch)
        t0 = time.perf_counter()
        qt.quantize_net(net, calib_mode="naive",
                        calib_data=[mx.nd.array(c) for c in calib],
                        num_calib_batches=cfg["calib_batches"])
        torch.cuda.synchronize()
        calib_s = time.perf_counter() - t0
        kinds = collections.Counter(type(b).__name__
                                    for b in net._iter_blocks())
        eager = net(X).asnumpy()
        seq8 = clf.bert(*_unpack(mx.nd, X))[0].asnumpy()
        net.hybridize(static_alloc=True)
        _kernel_counts(zero=True)
        first = net(X).asnumpy()
        launches = _kernel_counts()
        replay = net(X).asnumpy()
        records = _kernel_records(
            torch, lambda: [net(X) for _ in range(cfg["traced"])],
            FLASH_NAMES, warm=lambda: net(X), where="quantize")
        glaunch = TRACE_LAUNCHES[-1]["counted"]
        int8_ms = _cop_replay_ms(timer, net, cfg["replays"])
        del net, clf, X
    _free(torch)
    scale = float(np.abs(eager).max())
    return dict(kinds=dict(kinds), calibration_host_s=calib_s,
                logits_corr_fp32=_corr(eager, logits32),
                logits_max_abs_err_fp32=float(np.abs(eager - logits32).max()),
                seq_corr_fp32=_corr(seq8, seq32),
                seq_max_abs_err_fp32=float(np.abs(seq8 - seq32).max()),
                seq_max_abs_fp32=float(np.abs(seq32).max()),
                first_vs_eager=float(np.abs(first - eager).max()) / scale,
                replay_vs_eager=float(np.abs(replay - eager).max()) / scale,
                replay_bitwise_equal_eager=bool((replay == eager).all()),
                launches=launches, records=records,
                records_per_graph_launch=glaunch,
                int8_replay_ms=int8_ms, fp32_replay_ms=fp32_ms)


def _quant_optimize_for(torch, mx, path):
    """(b)'s optimize_for: the classifier with dropout 0.1 from the
    weights at ``path`` through the ``inference`` pass."""
    cfg = QUANT_NET
    x = _quant_inputs(np.random.RandomState(1), 30522, cfg["B"], cfg["L"])
    with mx.gpu(0):
        clf = _quant_classifier(mx, 0.1)
        clf.load_parameters(path, ctx=mx.gpu(0))
        inputs = _unpack(mx.nd, mx.nd.array(x))
        want = clf(*inputs).asnumpy()
        blk = clf.optimize_for(*inputs, backend="inference")
        ops = collections.Counter(n.op.name for n in blk._out_sym._topo()
                                  if n.op is not None)
        blk.hybridize(static_alloc=True)
        blk(*inputs)
        got = blk(*inputs).asnumpy()
        records = _kernel_records(
            torch, lambda: [blk(*inputs) for _ in range(QUANT_NET["traced"])],
            FLASH_NAMES, warm=lambda: blk(*inputs), where="optimize_for")
        glaunch = TRACE_LAUNCHES[-1]["counted"]
        bparams = blk.collect_params()
        shared = all(bparams[n] is p for n, p in
                     clf.collect_params().items() if n in bparams) \
            and len(bparams) == len(clf.collect_params())
        del blk, clf, inputs
    _free(torch)
    return dict(dropout_nodes=ops.get("Dropout", 0),
                flash_nodes=ops.get("_contrib_flash_selfatt", 0),
                max_err=float(np.abs(got - want).max())
                / float(np.abs(want).max()),
                records=records, records_per_graph_launch=glaunch,
                shares_parameters=shared)


def _quant_example(torch, mx, qt):
    """examples/quantize_int8.py's recipe on the card (entropy, 4
    calibration batches of 8 x 3 x 32 x 32; inputs from numpy)."""
    cfg = QUANT_EXAMPLE
    rng = np.random.RandomState(0)
    x = rng.uniform(-1, 1, (cfg["batch"], 3, 32, 32)).astype(np.float32)
    calib = [rng.uniform(-1, 1, (cfg["batch"], 3, 32, 32)).astype(
        np.float32) for _ in range(cfg["calib"])]
    nn = mx.gluon.nn
    mx.random.seed(0)
    with mx.gpu(0):
        net = nn.HybridSequential()
        net.add(nn.Conv2D(32, 3, padding=1, activation="relu"),
                nn.MaxPool2D(2),
                nn.Conv2D(64, 3, padding=1, activation="relu"),
                nn.MaxPool2D(2), nn.Dense(128, activation="relu"),
                nn.Dense(10))
        net.initialize(mx.init.Xavier())
        ref = net(mx.nd.array(x)).asnumpy()
        t0 = time.perf_counter()
        qnet = qt.quantize_net(net, calib_mode="entropy",
                               calib_data=[mx.nd.array(c) for c in calib])
        calib_s = time.perf_counter() - t0
        qnet.hybridize(static_alloc=True)
        out = qnet(mx.nd.array(x)).asnumpy()
        again = qnet(mx.nd.array(x)).asnumpy()
        del net, qnet
    return dict(corr=_corr(out, ref),
                max_abs_err=float(np.abs(out - ref).max()),
                calibration_host_s=calib_s,
                replay_equal=bool((again == out).all()))


def _quant_model(torch, mx, qt):
    """quantize_model over examples/lenet_symbol.py's symbol (seeded
    weights, naive calibration on one batch) run through Module on the
    card, against the float Module."""
    data, labels = _lenet_symbol_data()
    rng = np.random.RandomState(0)
    args = {"fc1_weight": rng.randn(128, 64).astype(np.float32) * 0.1,
            "fc1_bias": np.zeros(128, np.float32),
            "fc2_weight": rng.randn(10, 128).astype(np.float32) * 0.1,
            "fc2_bias": np.zeros(10, np.float32)}
    B = SYMBOLIC_LENET["batch"]
    outs = {}
    with mx.gpu(0):
        a = {k: mx.nd.array(v) for k, v in args.items()}
        x, y = mx.nd.array(data[:B]), mx.nd.array(labels[:B])
        qsym, qargs, aux = qt.quantize_model(
            _lenet_symbol(mx), a, data_names=("data", "softmax_label"),
            calib_mode="naive", calib_data=[(x, y)])
        for tag, s, p in (("int8", qsym, qargs),
                          ("fp32", _lenet_symbol(mx), a)):
            mod = mx.module.Module(s, data_names=("data",),
                                   label_names=("softmax_label",),
                                   context=mx.gpu(0))
            mod.bind(data_shapes=[("data", (B, 64))],
                     label_shapes=[("softmax_label", (B,))],
                     for_training=False)
            mod.set_params(p, aux)
            mod.forward(mx.io.DataBatch(data=[x], label=[y]),
                        is_train=False)
            outs[tag] = mod.get_outputs()[0].asnumpy()
            outs[tag + "_device"] = str(mod.get_outputs()[0]._data.device)
    return dict(quantized_args=sorted(qargs)[:4] + ["..."],
                corr=_corr(outs["int8"], outs["fp32"]),
                max_abs_err=float(np.abs(outs["int8"] - outs["fp32"]).max()),
                device=outs["int8_device"])


def _quant_card_host(torch, mx, qt, tmp):
    """Two layers at BERT-large width quantized (naive, one calibration
    batch) on the card and on the host from the same weights: the int8
    logits within one int8 step of the output's range (max|logit| /
    127: a float32 rounding boundary, met in another order on each, may
    flip one step)."""
    cfg = QUANT_HOST
    rng = np.random.RandomState(2)
    calib = _quant_inputs(rng, 30522, cfg["B"], cfg["L"])
    x = _quant_inputs(rng, 30522, cfg["B"], cfg["L"])
    path = os.path.join(tmp, "bert2.npz")
    outs = {}
    for tag, ctx in (("host", mx.cpu(0)), ("card", mx.gpu(0))):
        with ctx:
            clf = _quant_classifier(mx, 0.0, num_layers=cfg["num_layers"])
            if tag == "host":
                mx.random.seed(3)
                clf.initialize(mx.init.Normal(0.02))
                net = _packed(mx, clf)
                net(mx.nd.array(calib))
                clf.save_parameters(path)
            else:
                clf.load_parameters(path, ctx=ctx)
                net = _packed(mx, clf)
            qt.quantize_net(net, calib_mode="naive",
                            calib_data=[mx.nd.array(calib)])
            outs[tag] = net(mx.nd.array(x)).asnumpy()
            del net, clf
    tol = float(np.abs(outs["host"]).max()) / 127.0
    err = float(np.abs(outs["card"] - outs["host"]).max())
    return dict(num_layers=cfg["num_layers"], B=cfg["B"], L=cfg["L"],
                max_abs_err=err, tol=tol,
                bitwise_equal_share=float(np.mean(outs["card"]
                                                  == outs["host"])))


def phase_quantize(torch, timer):
    """``quantize``: contrib.quantization and optimize_for on the card
    (module comment above ``QUANT_NET``).  Returns B1's wrapper launches
    and records on the int8 and optimize_for paths."""
    import mxnet_tpu_torch as mx
    from mxnet_tpu_torch.contrib import quantization as qt
    t0 = time.perf_counter()
    tmp = tempfile.mkdtemp(prefix="mxnet-quantize-")
    try:
        path = os.path.join(tmp, "clf.npz")
        bert = _quant_bert(torch, mx, qt, timer, path)
        opt = _quant_optimize_for(torch, mx, path)
        example = _quant_example(torch, mx, qt)
        model = _quant_model(torch, mx, qt)
        card_host = _quant_card_host(torch, mx, qt, tmp)
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    _free(torch)
    cfg, layers = QUANT_NET, 24
    emit("quantize", model="bert_24_1024_16 BERTClassifier, use_flash",
         L=cfg["L"], B=cfg["B"], calib_mode="naive",
         calib_batches=cfg["calib_batches"], int8=bert,
         optimize_for=opt,
         quantize_int8_example=example, quantize_model=model,
         card_vs_host=card_host, seconds=time.perf_counter() - t0)
    check(bert["kinds"].get("QuantizedDense") == 4 * layers + 2
          and "Dense" not in bert["kinds"],
          f"quantize: blocks after quantize_net {bert['kinds']}")
    check(bert["replay_vs_eager"] <= QUANT_REPLAY_TOL
          and bert["first_vs_eager"] <= QUANT_REPLAY_TOL,
          f"quantize: int8 replay vs eager {bert['replay_vs_eager']} "
          f"(first call {bert['first_vs_eager']}) of max|logit|")
    check(bert["records"]["flash_attention_fwd"] == layers * cfg["traced"]
          and bert["records_per_graph_launch"]
          and len(bert["records_per_graph_launch"]) == cfg["traced"],
          f"quantize: {bert['records']} B1 records and "
          f"{len(bert['records_per_graph_launch'])} graph launches over "
          f"{cfg['traced']} replays")
    check(bert["launches"]["flash_attention_fwd"] == layers,
          f"quantize: B1 wrapper launches {bert['launches']} (the capture's "
          f"eager first call)")
    check(bert["seq_corr_fp32"] >= QUANT_MIN_CORR,
          f"quantize: int8 sequence output correlation "
          f"{bert['seq_corr_fp32']}")
    check(opt["dropout_nodes"] == 0 and opt["flash_nodes"] == layers
          and opt["max_err"] <= QUANT_OPT_TOL and opt["shares_parameters"],
          f"quantize: optimize_for {opt}")
    check(opt["records"]["flash_attention_fwd"] == layers * cfg["traced"]
          and len(opt["records_per_graph_launch"]) == cfg["traced"],
          f"quantize: optimize_for B1 records {opt['records']}")
    check(example["corr"] >= QUANT_MIN_CORR and example["replay_equal"],
          f"quantize: examples/quantize_int8.py {example}")
    check(model["corr"] >= QUANT_MIN_CORR
          and model["device"].startswith("cuda"),
          f"quantize: quantize_model through Module {model}")
    check(card_host["max_abs_err"] <= card_host["tol"],
          f"quantize: card vs host {card_host}")
    return dict(launches=bert["launches"], traced=bert["records"],
                optimize_for=opt["records"])


# ----------------------------------------------------------------- np_card
# (d) a table of mx.np / mx.npx calls on the card against the port's CPU
# (ops_card's rule: integer and boolean outputs equal, elementwise
# float32 within rtol 1e-5 / atol 1e-6; products and reductions, whose
# sums run in another order on each, within 1e-5 of max|out|;
# decompositions 1e-4 of max), and one mx.np Gluon block hybridized into
# a CUDA graph (one graph launch a call, its output within 1e-6 of max of
# the eager call).
NP_CARD_TOL = (1e-5, 1e-6)
NP_CARD_SUM_TOL = 1e-5
NP_CARD_DECOMP_TOL = 1e-4
NP_CARD_SUMS = ("matmul", "einsum", "sum", "mean_int", "var", "fft.rfft",
                "npx.fully_connected", "npx.softmax", "linalg.norm")


def _np_card_cases(np_, npx):
    """[(name, fn(arrays...), [numpy inputs])]."""
    r = np.random.RandomState(0)
    f = r.randn(64, 48).astype(np.float32)
    g = r.randn(48, 32).astype(np.float32)
    p = r.rand(64, 48).astype(np.float32) + 0.5
    i = r.randint(-50, 50, (64, 48)).astype(np.int32)
    v = r.randn(1000).astype(np.float32)
    sq = (r.randn(16, 16) + 4 * np.eye(16)).astype(np.float32)
    return [
        ("add", lambda a, b: np_.add(a, b), [f, p]),
        ("matmul", lambda a, b: np_.matmul(a, b), [f, g]),
        ("einsum", lambda a, b: np_.einsum("ij,jk->ik", a, b), [f, g]),
        ("dot_int", lambda a: np_.dot(a, np_.ones((48, 3), dtype="int32")),
         [i]),
        ("sum", lambda a: np_.sum(a, axis=0), [f]),
        ("mean_int", lambda a: np_.mean(a, axis=1), [i]),
        ("var", lambda a: np_.var(a, axis=1), [f]),
        ("cumsum", lambda a: np_.cumsum(a, axis=1), [i]),
        ("argsort", lambda a: np_.argsort(a, axis=1), [f]),
        ("sort", lambda a: np_.sort(a), [v]),
        ("where", lambda a, b: np_.where(a > 0, a, b), [f, p]),
        ("clip", lambda a: np_.clip(a, -0.5, 0.5), [f]),
        ("exp_log", lambda a: np_.log(np_.exp(a) + 1), [f]),
        ("transpose", lambda a: np_.transpose(a), [f]),
        ("concatenate", lambda a, b: np_.concatenate([a, b], axis=0),
         [f, p]),
        ("take", lambda a: np_.take(a, np_.array([0, 5, 63], dtype="int32"),
                                    axis=0), [f]),
        ("pad", lambda a: np_.pad(a, 2, mode="reflect"), [f]),
        ("unique", lambda a: np_.unique(a), [i]),
        ("histogram", lambda a: np_.histogram(a, bins=16)[0], [v]),
        ("linalg.inv", lambda a: np_.linalg.inv(a), [sq]),
        ("linalg.norm", lambda a: np_.linalg.norm(a), [f]),
        ("fft.rfft", lambda a: np_.abs(np_.fft.rfft(a)), [v]),
        ("npx.relu", lambda a: npx.relu(a), [f]),
        ("npx.softmax", lambda a: npx.softmax(a), [f]),
        ("npx.fully_connected", lambda a, b: npx.fully_connected(
            a, np_.transpose(b), np_.zeros((32,)), num_hidden=32), [f, g]),
        ("npx.one_hot", lambda a: npx.one_hot(np_.abs(a) % 7, 7), [i]),
        ("npx.topk", lambda a: npx.topk(a, k=3), [f]),
    ]


def _np_block(mx):
    """A user HybridBlock written in mx.np / mx.npx over a weight."""
    np_, npx = mx.np, mx.npx

    class NpMLP(mx.gluon.HybridBlock):
        def __init__(self, **kw):
            super().__init__(**kw)
            with self.name_scope():
                self.w = self.params.get("w", shape=(48, 32))

        def hybrid_forward(self, F, x, w):
            h = np_.tanh(np_.matmul(x, w))
            return np_.sum(npx.relu(h) * np_.cos(h), axis=-1)

    return NpMLP(prefix="npmlp_")


def phase_np_card(torch):
    """``np_card`` (module comment above ``NP_CARD_TOL``)."""
    import mxnet_tpu_torch as mx
    t0 = time.perf_counter()
    rows, worst = [], {}
    for name, fn, inputs in _np_card_cases(mx.np, mx.npx):
        outs = {}
        for tag, ctx in (("card", mx.gpu(0)), ("host", mx.cpu(0))):
            with ctx:
                res = fn(*[mx.np.array(a) for a in inputs])
                outs[tag] = (res.asnumpy(), _dtname(res._data.dtype),
                             str(res._data.device))
        card, host = outs["card"], outs["host"]
        err, ok = None, card[0].shape == host[0].shape \
            and card[1] == host[1]
        if ok and card[0].dtype.kind in "biu":
            err = float(np.abs(card[0].astype(np.int64)
                               - host[0].astype(np.int64)).max(initial=0))
            ok = err == 0
        elif ok:
            scale = float(np.abs(host[0]).max()) or 1.0
            err = float(np.abs(card[0] - host[0]).max())
            if name in NP_CARD_SUMS:
                ok = err <= NP_CARD_SUM_TOL * scale
            elif name.startswith("linalg"):
                ok = err <= NP_CARD_DECOMP_TOL * scale
            else:
                ok = bool(np.allclose(card[0], host[0], rtol=NP_CARD_TOL[0],
                                      atol=NP_CARD_TOL[1]))
        ok = ok and card[2].startswith("cuda")
        worst[name] = err
        if not ok:
            rows.append(dict(name=name, card=card[1:], host=host[1:],
                             err=err))
    x = np.random.RandomState(1).randn(64, 48).astype(np.float32)
    with mx.gpu(0):
        blk = _np_block(mx)
        blk.initialize(mx.init.Normal(0.1))
        X = mx.nd.array(x)
        eager = blk(X).asnumpy()
        blk.hybridize(static_alloc=True)
        blk(X)
        replay = blk(X).asnumpy()
        _kernel_records(torch, lambda: [blk(X) for _ in range(3)],
                        FLASH_NAMES, warm=lambda: blk(X), where="np_card")
        glaunch = TRACE_LAUNCHES[-1]["counted"]
        del blk
    block_err = float(np.abs(replay - eager).max()) / float(
        np.abs(eager).max())
    emit("np_card", functions=len(worst), max_errs=worst, failed=rows,
         block_rel_err=block_err, block_records_per_graph_launch=glaunch,
         seconds=time.perf_counter() - t0)
    check(not rows, f"np_card: card vs host {rows}")
    check(block_err <= 1e-6 and len(glaunch) == 3,
          f"np_card: the mx.np block's replay {block_err} of max, "
          f"{len(glaunch)} graph launches over 3 calls")


def _sig_stats_rows(stats):
    return [{k: s[k] for k in ("inputs", "training", "instances",
                               "capture_s", "pool_bytes")}
            for s in stats["signatures"]]


def main():
    if sys.argv[1:2] == ["--durability-child"]:
        return durability_child(*sys.argv[2:])
    if sys.argv[1:2] == ["--dist-worker"]:
        return dist_worker(*sys.argv[2:])
    if sys.argv[1:2] == ["--gluon-worker"]:
        return gluon_worker(*sys.argv[2:])
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; the port's smoke test runs "
              "only on the card", file=sys.stderr)
        return 1
    from mxnet_tpu_torch import compile_cache
    from mxnet_tpu_torch.models import TransformerDecoderLM
    from mxnet_tpu_torch.ops import build
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    torch.set_float32_matmul_precision("highest")
    dev = torch.device("cuda:0")
    kind = torch.cuda.get_device_name(0)
    smi = nvidia_smi()
    emit("device", name=kind, count=torch.cuda.device_count(),
         nvidia_smi=smi, torch=torch.__version__, cuda=torch.version.cuda)

    t0 = time.perf_counter()
    built = build.build()
    emit("build", seconds=time.perf_counter() - t0,
         sources={n: dict(seconds=b["seconds"], cached=b["cached"],
                          ptxas=ptxas_summary(b["ptxas"] or ""))
                  for n, b in built.items()},
         compile_cache=compile_cache.get_default().stats())
    # ptxas reports come with the libraries compiled in this run; one
    # copied from the persistent cache (MXNET_COMPILE_CACHE_DIR) has none
    compiled = {n: b for n, b in built.items() if not b["cached"]}
    if "flash_attention_fwd" in compiled:
        log = compiled["flash_attention_fwd"]["ptxas"]
        wgmma = [ln for ln in ptxas_summary(log)
                 if "flash_fwd_wgmma_kernel" in ln]
        check(wgmma and all("0 bytes spill stores, 0 bytes spill loads"
                            in ln for ln in wgmma)
              and "serialized" not in log,
              f"build: the bf16 forward kernel spills or serialises its "
              f"wgmma: {ptxas_summary(log)}")
    check_tf32_build(build, compiled)
    cache_dir = phase_build_cache(build, compile_cache)

    timer = Timer(torch, dev)
    report = phase_kernels(torch, dev, timer)
    phase_head_dims(torch, dev)
    flash_rows = phase_flash_kernels(torch, dev, timer)
    lm = TransformerDecoderLM(**GPT2_SMALL, device=dev,
                              generator=torch.Generator().manual_seed(0))
    lm.eval()
    phase_parity(torch, dev, lm)
    launches, served = phase_serve(torch, dev, lm)
    predict = phase_predict(torch, dev, lm, served)
    replicas = phase_replicas(torch, dev, lm, served)
    traffic = phase_traffic(torch, dev, lm, served, predict)
    artifact = phase_artifact(torch, dev)
    artifact_quant = phase_artifact_quant(torch, dev, timer)
    head, feats, labels = phase_train_parity(torch, dev)
    train_launches, (trainers, step_ms), batch = phase_train(
        torch, dev, head, feats, labels)
    durability = phase_durability(torch, dev, feats, labels,
                                  step_ms["graphs"],
                                  model_kw=dict(num_layers=DURABILITY_LAYERS))
    phase_durability_rng(torch, dev, feats)
    phase_durability_signal(torch, cache_dir)
    shutil.rmtree(os.path.dirname(cache_dir), ignore_errors=True)
    # last: the profiler's device tracing slows every later launch (the
    # profiles take their untraced times before they trace)
    phase_profile(torch, dev, lm)
    phase_profile_train(torch, trainers, batch, step_ms)
    del trainers
    durability_launches = durability["launches"]
    durability_traced = phase_durability_trace(torch, durability)
    del durability
    _free(torch)
    train_traced = phase_train_graphs(torch, dev, head, feats, labels)
    del head
    _free(torch)
    dist_launches = phase_dist(torch)
    phase_gluon_lenet(torch)
    gluon_launches = phase_gluon_flash(torch)
    gluon_dist_launches = phase_gluon_dist(torch)
    gluon_hybrid = phase_gluon_hybrid(torch)
    phase_gluon_mnist(torch)
    phase_gluon_ssd(torch)
    gluon_fused = phase_gluon_fused(torch)
    gluon_moe = phase_gluon_moe(torch)
    phase_faster_rcnn(torch)
    symbolic = phase_symbolic(torch, gluon_hybrid["encoder"])
    phase_word_lm(torch)
    zoo_step_ms = phase_model_zoo(torch)
    phase_imagenet(torch, zoo_step_ms)
    phase_ops_card(torch, dev)
    bert_squad = phase_bert_squad(torch)
    nmt = phase_nmt(torch)
    amp_run = phase_amp(torch)
    quant = phase_quantize(torch, timer)
    phase_np_card(torch)
    phase_graphs(torch, dev, lm)
    replayed = phase_serve_trace(torch, lm)
    predict_traced = phase_predict_trace(torch, predict)
    artifact_traced = phase_artifact_trace(torch, dev)
    quant_traced = phase_artifact_quant_trace(torch, dev, artifact_quant)
    replicas_traced = phase_replicas_trace(torch, replicas)
    traffic_traced = phase_traffic_trace(torch, dev, lm, traffic)
    emit("trace_launches", traces=TRACE_LAUNCHES)

    pk = "mxnet_tpu/ops/pallas_kernels.py"
    kernels = []
    # each entry: the fp32 numbers, and the same numbers in bf16 beside
    # them (training, the flash kernels' main path, runs in bf16)
    for name, replaces in (("ragged_paged_attention", f"{pk}:586"),
                           ("ragged_paged_verify", f"{pk}:751")):
        by_dtype = {}
        for dtype in ("float32", "bfloat16"):
            rows = [r for r in report[name] if r["dtype"] == dtype]
            # B4: the mixed contexts (0 to 1024 tokens); B5: W = 256
            main_row = max(rows, key=lambda r: r.get("W", 0)) \
                if name == "ragged_paged_verify" \
                else next(r for r in rows if r["shape"] == "mixed")
            by_dtype[dtype] = dict(
                max_abs_err=max(r["max_abs_err"] for r in rows),
                ms=main_row["ms"], plain_ms=main_row["plain_ms"],
                bound_ms=main_row["bound_ms"], bound_by=main_row["bound_by"],
                library_ms=main_row["library_ms"])
        entry = dict(
            name=name, route="cuda",
            source=f"mxnet_tpu_torch/csrc/{name}.cu", replaces=replaces,
            launches=launches[name],
            traced_serve_kernel_records=replayed[name],
            launches_generate=predict["launches"][name],
            launches_replicas=replicas["launches"][name],
            launches_traffic=traffic["launches"][name],
            traced_traffic_kernel_records=traffic_traced[name],
            **by_dtype["float32"], bfloat16=by_dtype["bfloat16"])
        entry["launches_bert_squad"] = bert_squad["launches"][name]
        entry["launches_nmt"] = nmt["launches"][name]
        if name == "ragged_paged_attention":
            entry["launches_gluon_nd"] = gluon_launches[name]
        # every row of the kernels phase, with the plan's split
        keys = ("dtype", "shape", "W", "B", "n_split", "ms", "bound_ms",
                "library_ms") if name == "ragged_paged_verify" else (
            "dtype", "shape", "n_split", "chunk", "ms", "ms_with_host",
            "bound_ms", "library_ms")
        entry["rows"] = [{k: r[k] for k in keys} for r in report[name]]
        kernels.append(entry)
    # flash kernels: times at the training batch's shape; errors the
    # largest one over every shape; the library time of B2 and B3 is one
    # SDPA backward computing dQ, dK and dV together
    for name, key, err, replaces in (
            ("flash_attention_fwd", "fwd", "out", f"{pk}:83"),
            ("flash_attention_bwd_dq", "bwd_dq", "dq", f"{pk}:144"),
            ("flash_attention_bwd_dkv", "bwd_dkv", "dkv", f"{pk}:191")):
        by_dtype = {}
        for dtype in ("float32", "bfloat16"):
            rows = [r for r in flash_rows if r["dtype"] == dtype]
            main_row = next(r for r in rows if r["shape"] == "train_batch")
            t = main_row[key]
            traced = train_traced[dtype]
            by_dtype[dtype] = dict(
                max_abs_err=max(r["max_abs_err"][err] for r in rows),
                ms=t["ms"], plain_ms=t["plain_ms"], bound_ms=t["bound_ms"],
                bound_by=t["bound_by"],
                library_ms=t["library_ms"] if key == "fwd"
                else main_row["library_bwd_ms"],
                launches_graphs=train_launches[dtype]["graphs"][name],
                launches_eager=train_launches[dtype]["eager"][name],
                traced_train_kernel_records=traced["records"][name],
                traced_train_replays=traced["replays"])
        # the main path is the graphs trainer (both dtypes): its wrapper
        # count is each signature's first, eager step; its replays are
        # counted from trace records (traced_train_kernel_records)
        entry = dict(
            name=name, route="cuda",
            source=f"mxnet_tpu_torch/csrc/{name}.cu", replaces=replaces,
            launches=sum(train_launches[d]["graphs"][name]
                         for d in train_launches),
            **by_dtype["float32"], bfloat16=by_dtype["bfloat16"],
            launches_durability=durability_launches[name],
            traced_durability_kernel_records=durability_traced[name],
            launches_dist_nccl=dist_launches["dist_nccl"][name],
            traced_dist_nccl_kernel_records=dist_launches[
                "dist_nccl_traced"][name],
            launches_dist_tp=dist_launches["dist_tp"][name],
            launches_dist_dp_int8=dist_launches["dist_dp_int8"][name],
            launches_gluon_flash=gluon_launches[name],
            launches_gluon_dist=gluon_dist_launches[name],
            launches_gluon_hybrid=gluon_hybrid["launches"][name],
            traced_gluon_hybrid_kernel_records=gluon_hybrid["traced"][name],
            launches_symbolic=symbolic["launches"][name],
            traced_symbolic_kernel_records=symbolic["traced"][name],
            launches_symbolic_bucketing={
                L: c[name] for L, c in symbolic["bucketing"].items()},
            launches_gluon_fused=gluon_fused["launches"][name],
            traced_gluon_fused_kernel_records=gluon_fused["traced"][name],
            launches_gluon_moe=gluon_moe["launches"][name],
            traced_gluon_moe_kernel_records=gluon_moe["traced"][name],
            launches_dist_ep=dist_launches["dist_ep"][name],
            launches_bert_squad=bert_squad["launches"][name],
            traced_bert_squad_kernel_records=bert_squad["traced"][name],
            launches_nmt=nmt["launches"][name],
            launches_amp_bf16=amp_run["launches"][name],
            traced_amp_bf16_kernel_records=amp_run["traced"][name])
        if key == "fwd":
            # the predict path (fp32): the bucket graphs' captures launch
            # B1 from the wrapper; their replays are counted from trace
            # records over the traced rerun's batches; its times at the
            # bucket-16 batch's shape
            p16 = next(r for r in flash_rows if r["dtype"] == "float32"
                       and r["shape"] == "predict_bucket16")
            entry.update(
                predict_bucket16=dict(max_abs_err=p16["max_abs_err"]["out"],
                                      **p16["fwd"]),
                launches_predict=predict["launches"][name],
                traced_predict_kernel_records=predict_traced["records"],
                traced_predict_batches=predict_traced["batches"],
                launches_artifact=artifact["launches"],
                traced_artifact_kernel_records=artifact_traced["records"],
                traced_artifact_replays=artifact_traced["replays"],
                launches_artifact_quant=artifact_quant["launches"],
                traced_artifact_quant_kernel_records=quant_traced["records"],
                traced_artifact_quant_replays=quant_traced["replays"],
                launches_replicas=replicas["launches"][name],
                traced_replicas_kernel_records=replicas_traced["b1_records"],
                traced_replicas_replays=replicas_traced["b1_replays"],
                launches_traffic=traffic["launches"][name],
                traced_traffic_kernel_records=traffic_traced[name],
                launches_quantize=quant["launches"][name],
                traced_quantize_kernel_records=quant["traced"][name],
                traced_optimize_for_kernel_records=quant[
                    "optimize_for"][name])
        kernels.append(entry)
    print(json.dumps({"kernels": kernels}), flush=True)
    print(smi, flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind,
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
