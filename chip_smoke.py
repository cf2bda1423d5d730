"""Chip smoke test of the PyTorch/CUDA port (``kubeflow_tpu_torch``).

Run from the repository root on a machine with one NVIDIA H100:

    python3 chip_smoke.py

Phases (any failure exits non-zero; nothing is caught and skipped):

1. build   — the card's name and power limit, torch/CUDA versions, and the
             build of every CUDA kernel from ``kubeflow_tpu_torch/ops/csrc``
             (one nvcc per source, all at once);
2. kernels — the KV-cache writes at GPT-small serving shapes (8 slots,
             12 heads x 64, 2048 positions, 16-row blocks), with
             out-of-range cursors and a trash-table entry, held bit for bit
             (``torch.equal``) against their plain PyTorch versions on the
             card: the pairs ``kv_row_update_pair`` (contiguous cache),
             ``kv_block_update_pair`` and ``kv_block_update_quant_pair``
             (paged arenas): a layer's K and V in one launch; each run
             twice, as are two calls of the one-array wrappers over the
             same kernel, and every design through ``kv_row_update_cfg``
             and ``kv_block_update_cfg``, the replaced one-array kernel as
             design 0; every refusal of the pair wrappers raises; the
             launch floor (an empty kernel at the one-array write's grid:
             device ms, and call ms through the wrappers' launch path);
             per layer the call ms (back-to-back calls), device ms, the
             plain version, two calls of the one-array wrapper, each
             design on the device, ``index_put_`` ×2 (in-range rows at
             indices computed on the host: less work than the kernels; by
             call and its kernels alone on the device) and the bytes
             bound;
3. serve   — GPT-small (seeded random weights) behind ``ModelServer`` on
             port 0, paged bf16 arena, 8 slots: 8 concurrent greedy HTTP
             requests, prompts of 16-256 tokens, 32 new tokens each, once
             through the kernels and once through the plain writes; the
             tokens must be identical, ``kv_block_update_pair`` must launch
             once per layer and decode step (and ``kv_block_update``
             never); then one request of a 600-token prompt, over the
             largest prefill bucket: served through chunked prefill (3
             chunks of 256), held to ``generate()`` on the same weights
             (equal, or differing first where generate()'s own top-2 logit
             gap is under 0.05: a bf16 near-tie, printed);
4. contig  — the same requests with the contiguous cache through
             ``kv_row_update_pair`` (once per layer and step, and
             ``kv_row_update`` never): tokens identical to phase 3's; its
             600-token prompt, with ``prefill_chunk=0``, takes the static
             ``generate()`` path and must equal ``generate()`` exactly;
5. int8    — the same requests with the int8 arena through
             ``kv_block_update_quant_pair`` (once per layer and step, and
             ``kv_block_update_quant`` never): tokens identical to the int8
             plain run; agreement with the bf16 tokens is printed;
5a. serve_chunked — in each layout (paged bf16, contiguous, int8), kernels
             on, the default chunk 256: ``prewarm(16)`` (the paged engine's
             alone, before the three), then the 8 prompts
             and a 1,500-token one (6 chunks) at once, 32 new tokens each:
             the pair kernel 12 launches a decode step and the one-array
             wrapper none, 6 prefill chunks, the 8 outputs equal to that
             layout's phase 3-5 run, the KV blocks back to 0, the long
             prompt held to ``generate()`` as in phase 3; the short
             requests' TTFT p50 with and without the long prompt in flight
             and the long prompt's own; a second long prompt cancelled by
             ``cancel_requests(1)`` after its first chunk fails with
             RequestCancelled and frees its slot and blocks;
5b. obs    — on the paged server of 5a: ``/metrics`` (OpenMetrics content
             type, ``# EOF``, the TTFT buckets, the chunk counter), the long
             request's ``serving.request`` span with its 6 ``prefill_chunk``
             events from ``/debug/traces``, ``/debug/vars``,
             ``/debug/stacks`` (the ``continuous-batcher`` thread);
5c. bert_serve — BERT-base (seeded weights, L 128) behind ``ModelServer``:
             16 concurrent single-instance requests unbatched, then batched
             (``batching=True``), plus one over HTTP: each batched answer
             within 0.1 of its unbatched one (>= 99% argmax agreement), a
             mean batch above one row, ``flash_fwd`` 12 launches a forward
             (``auto_attention``, non-causal); requests/s and latency p50 /
             p99 both ways; then ``auto_attention`` against
             ``full_attention`` at L 128 and 100, bf16 and f32: 12
             ``flash_fwd`` launches a forward, within 0.1, every argmax
             flip a near-tie under 0.05; f32 with >= 99% argmax agreement;
             bf16 with each layer's attention off ``full_attention``'s in
             <= 2% of elements on the same inputs, and as close to the f32
             model's argmax as the bf16 ``full_attention`` model, less
             1%;
5d. spec_serve — GPT-small served speculatively (``spec_k`` 4, the 3-layer
             self-draft ``init_from_target(draft_config(cfg), params)``) in
             the three layouts, then with the target as its own draft in
             paged bf16 and contiguous, the 8 prompts of phases 3-5: each
             request's tokens equal to the layout's phase 3-5 kernel-path
             tokens or differing first at a near-tie (under 0.05) of that
             route; ``kv_row_update_pair`` once per draft layer and draft
             step (3 × 4 or 12 × 4 a round) and no paged write; the target
             as draft accepting at least 0.8 of its drafts (rounds that
             commit several tokens); the accept rate, rounds, tokens/s and
             TTFT p50 beside the phase 3-5 run's;
5e. distill — ``distill_draft`` at its defaults (300 steps, batch 8, 32
             sequences of 16 + 48 tokens) on a GPT-small teacher, saving
             the draft through ``checkpoint_dir``: 15 ``flash_fwd``, 3
             ``flash_bwd_dq`` and 3 ``flash_bwd_dkv`` launches a step, the
             last step's KL below the first's; the checkpoint read back
             (``Checkpointer.restore_numpy``: meta ``kind`` "spec_draft",
             the run's ``steps`` and ``final_kl``) and carried into the
             port (``params_from_flax``) bit-equal to the distilled draft,
             whose restored copy's ``measure_accept_rate`` is at least the
             self-draft's; steps/s, the checkpoint's save and restore
             seconds and bytes on disk;
5f. disagg — a prefill-role engine handing off to a decode-role engine
             (``submit_handoff`` as its sink), paged bf16 and int8, each
             without and with the speculative self-draft: the 8 prompts and
             a 1,500-token one (6 chunks on the prefill side) equal to a
             unified engine's tokens exactly; without the draft, one
             request alone first, after which the decode engine's arena
             blocks equal the never-moved engine's (``torch.equal``); the
             decode side's launches (the layout's pair 12 a decode step, or
             ``kv_row_update_pair`` 36 a round); blob bytes and
             ``serving_kv_handoff_seconds`` p50/p99;
5g. fleet  — GPT-small served by ``EngineFleet``s sharing the card and one
             set of weights: (a) ``gpt_served_model(replicas=2)``
             (``max_replicas`` 3) over HTTP, the 8 prompts spread over both
             replicas, then the first 4 again: tokens held to phase 3's
             (``near_tie``), the second pass routed by prefix (4 hits),
             ``kv_block_update_pair`` 12 a decode step of either replica
             and no other write, ``/debug/fleet`` naming both; (b) 24
             requests on two replicas, then ``scale_to(1)``: every one
             completes with phase 3's tokens, at least one re-queued;
             ``fleet_drain_seconds``; (c) ``SLOAutoscaler`` with
             ``ttft_slo`` a tenth of (a)'s TTFT p50: bursts between ticks
             scale 1 → 2 once, then the cooldown holds it; the new
             replica's cold-start seconds; (d) two models (seeds 0 and 1)
             over prefill and decode pools, paged bf16 and int8: each
             model's tokens held to a single engine's with its weights,
             one KV import a request, the decode pool's pair kernel 12 a
             decode step; tokens/s, TTFT p50, handoff p50/p99. Phases 5a-5g
             run after phase 19a, before kv_probe: they start threads and
             servers, and read no profiler window;
6. ref     — a tiny f32 model's prefill logits and greedy tokens on the
             card against the same model on the CPU;
7. profile — GPT-small's decode step alone, paged and contiguous: host ms
             per step and the device-busy share with the top kernels
             (torch.profiler); the KV writes' launches per step (12),
             their device ms and their host ms per step;
8. flash   — the three flash-attention kernels at the training path's
             shapes (b 8, h 16, L 1024, d 64, causal, bf16) against their
             plain versions (atol 2e-2 on out/dq/dk/dv, 1e-3 on lse), at f32
             shapes (b 2, h 2, L 256, d 32 and 64; atol 1e-4), non-causal,
             lq != lk, q_offset = lk, k_offset = 10 lk (every row masked:
             zeros, lse -1e30, dq 0), the same edges in bf16 (d 32 and 128,
             ragged 100/130 at d 128; atol 2e-2, lse 1e-3: the tensor-core
             kernels), BERT-base's served attention (bf16, non-causal, h 12,
             d 64, b 16 at L 128 and b 8 at L 100) and bf16_dots; head_dim
             16 in f32 and bf16 over the same edges (ragged 100/130), d 8
             and d 80 through the padding to 16 and 128, d 160 refused;
             the forward's f32 out on bf16 inputs (rounded to bf16: the
             bf16 out bit for bit; against the plain f32 out within 1e-4,
             2e-2 under bf16_dots); the split: at d 16, 32, 64 and 128, out,
             dq, dk and dv differ from the f32 answer rounded to bf16 in at
             most 2% of elements (p and ds as hi + lo), and in more under
             bf16_dots (hi alone); each kernel run twice and compared bit
             for bit; per-call times beside the bound, the plain versions
             and PyTorch's scaled_dot_product_attention (event time, and
             the device time of every kernel it launches: achieved TF/s,
             device ms over SDPA's device ms); the port's whole backward
             (``flash_bwd_whole``: delta, dq, dk/dv) against SDPA's
             backward alone, on the device, and a check that the bf16
             backward ran the tensor-core dq kernel; per-call times of the
             three kernels at d 16 (b 8, h 16, L 1024, bf16, causal) beside
             their bounds, and the forward with an f32 out at the main
             shape beside its bf16 out;
9. train_ref — a tiny f32 GPT: loss and every gradient through the kernels
             on the card against the plain path on the CPU (atol 1e-4);
10. train  — the bench's GPT-2-medium-class config at full width (b 8,
             L 1024), the counted reference step then 8 AdamW steps through
             the kernels (24 launches of each per step), then the same
             through the plain attention (no launch): finite losses, step-1
             losses within 0.02, trajectories within 0.05, falling loss; step
             ms, tokens/s, peak memory, the counted and the bench's analytic
             FLOPs, mfu and the step breakdown; the kernel run's per-step
             ``attribution`` row held as 22a holds the bench's;
11. train_profile — host ms of unprofiled train steps, then one step under
             torch.profiler: device-busy share, top kernels, the flash
             kernels' share of the step (every one of their launches seen);
12. resnet_kernels — the two fused-block kernels at each of ResNet-50's
             block shapes (batch 256, bf16 x) against their plain versions
             (max abs error at most 1e-2 of the output's largest magnitude),
             each run twice for the same bits, odd hw at stride 2 refused;
             per shape: the band, ms per call, device ms (read by profiler
             name: ``fused_bottleneck_kernel_mma`` and
             ``fused_transition_kernel_mma`` on this bf16 path), TF/s,
             plain ms, a cuDNN yardstick (several calls) by call and on
             the device, and the bound;
13. resnet_ref — a tiny fused ResNet with f32 activations: loss and every
             gradient through the kernels on the card against the plain path
             on the CPU (loss 1e-3, gradients 2e-2 of their largest value);
14. resnet_train — the bench's ResNet-50 config at full width and depth
             (batch 256, 224 x 224, s2d stem, SGD-momentum), 8 steps through
             the kernels (12 fused_bottleneck and 4 fused_transition launches
             per step), the same 8 steps through the plain versions (no
             launch; losses within 1e-2 at step 1 and 5e-2 over the run), and
             4 steps of the unfused model as a yardstick; step ms, images/s,
             peak memory, the counted (an unfused step) and the bench's
             analytic FLOPs, mfu and the step breakdown; the kernel run's
             per-step ``attribution`` row held as 22a holds the bench's;
15. resnet_profile — one ResNet-50 step under torch.profiler: device-busy
             share, top kernels, the fused-block kernels' share (all 16 of
             their launches seen, by the names of phase 12);
16. stream_kernels — the two streaming-copy kernels at the probe's shapes
             (bf16 [802816, 256] and [256, 56, 56, 256]): stream_copy with
             2-D and 4-D blocks and stream_copy_dma, each run twice and held
             bit for bit (``torch.equal``) against ``stream_copy_plain``;
             every refused shape raises; per call: ms, device ms, plain ms,
             ``torch.mul`` by call and on the device, the bound and GB/s,
             the device ms of the design each kernel replaced (the sweep's
             design 0, launched beside it), and the launch shapes (grid,
             block, registers) of the kernel and of ``torch.mul`` from a
             profiler trace;
17. probe  — ``kubeflow_tpu_torch.e2e.fused_bottleneck_probe.main()`` at its
             full shapes: its six rows (composite, fused kernel, torch.mul,
             the three copies), one line each;
18. ceiling — the device-ceiling probe's ``sweep()`` (bf16 matmul and conv
             TF/s, f32 triad GB/s) and ``flash_sweep()`` (the flash kernels
             forward + backward at 8192 tokens);
19. step_profiles — ``profile_step`` (ResNet-50, batch 256) and
             ``gpt_profile`` (b 8, L 1024), fewer steps;
19a. spec_write — a speculative round's verify-forward KV write (4 rows a
             slot, 8 slots, GPT-small's arenas and cache) through the
             multi-row paths the verify runs (``kv_block_update_ref``, int8
             after ``quantize_kv``, the contiguous indexed store), against
             4 launches of the layout's pair kernel at cursors + j, which
             leave the same bytes (``torch.equal``); call and device ms a
             layer and a round;
19b. resnet_data — the bench's ResNet-50 step (batch 256, 224 x 224) fed
             by ``synthetic_classifier_source`` for 4 steps through
             ``DataPipeline`` (pinned buffers, a side stream, a producer
             thread) and 4 with no prefetch (each batch drawn and copied on
             the training thread), from the same seeded weights:
             ``data_wait_s_per_step``, step ms, images/s, finite losses,
             12 ``fused_bottleneck`` and 4 ``fused_transition`` launches a
             step, the two runs' first losses within 1e-3; then the model's
             variables through the ``Checkpointer`` into a fresh model:
             every tensor bit-equal, the eval logits equal; save and
             restore seconds, bytes on disk;
19c. mnist_trial — the HPO trial ``mnist_objective`` on the card at JAX's
             defaults (30 steps, batch 64): the loss falls, the accuracy
             in [0, 1]; a ``report_fn`` returning False at step 10 stops it
             there with that report's metrics; seconds a trial. Phases
             19b-19g run after 19a and read no profiler window;
19d. profile_clock — the bench's GPT training loop (b 8, L 1024, AdamW)
             for 8 steps in a thread, its ``StepClock`` registered as
             "train"; ``start_profile_server(0)`` (a second port raises);
             after step 2, ``GET /debug/profile?clock=train&steps=2&timeout=60``
             returns exactly 2 consecutive steps recorded after the
             request, each with its compute and fetch phases; an unknown
             clock 404, a non-numeric ``steps`` 400; each flash kernel 24
             launches a step;
19e. serving_bench — ``kubeflow_tpu_torch.e2e.serving_bench`` at full
             width (BERT-base, GPT-medium) with cut depth: BERT over HTTP
             at buckets 1/8/32, 8 timed requests each (``flash_fwd`` 12 a
             forward); ``generate()`` at batch 1 and 8, 32 new tokens (no
             kernel: its scalar-cursor cache is written by an indexed
             store); 8 requests at 8 slots, budgets 16/24/32/40, static
             path (no kernel) against the paged engine
             (``kv_block_update_pair`` 24 a decode step), then a draft
             distilled for 20 steps (flash 30 + 6 + 6 a step) and the spec
             pass (``kv_row_update_pair`` 6 x 4 a round), each request's
             tokens held to the static path's (``near_tie``); two models
             over prefill and decode pools, int8, 3 requests of 16 tokens
             (every request "ok", one KV import each,
             ``kv_block_update_quant_pair`` 24 a decode step); every row
             printed;
19f. stage_profile — the stem and the four ResNet-50 stages at batch 256,
             BatchNorm in train mode, 3 timed steps a tower: ms, counted
             GFLOP and TF/s (unfused blocks, no fused-block launch);
19g. conv_experiments — the 14 convolution-ceiling probes at their full
             shapes, 4 timed calls of 8 chained steps each: TF/s;
19h. autotune_attribution — the attribution driver's four checks on the
             card (the bench rows' sweeps run in 22a);
22a. bench — ``kubeflow_tpu_torch.bench``'s five rows at full width and
             cut depth: ``run_resnet`` (batch 256 of 224², the s2d stem,
             ``fused_blocks="auto"``: both candidates measured, 4 + 1
             steps each, ``fused_bottleneck`` 12 and ``fused_transition`` 4
             a step of the fused one and none of the unfused one; the
             choice printed beside the prediction; then a warm-up window
             and 2 timed windows of 4 steps, each from the same restored
             state (their last losses within 1e-4 of each other,
             relative), launches a step of the choice) and ``run_gpt`` (b 8 x
             1024, ``autotune=True``: remat off and on priced on meta
             tensors, remat pruned, the other measured at 24 launches of
             each flash kernel a step; then the counted step and 3
             windows of 4 steps, the timed ones' last losses as ResNet's);
             both rows go through ``training/{resnet,gpt}.py``
             ``prepare``, the sweep and setup ``train()`` runs; each
             ``attribution`` row held to the
             report rebuilt from its clock (fractions sum to 1 within
             1e-6, phases rebuild the window within 5%), its ``compute``
             to the CUDA events around that phase (within 5%) and its
             walk's FLOPs to the row's counted step (within 3% ResNet, 8%
             GPT); the fused ResNet walk at 224 x 224 covers 16/16
             bottlenecks with only the stem and the head unfused; the
             serving row assembled by ``bench.serving_row`` from 19e's
             four passes (no extra pass); ``run_hpo`` at 4 MNIST trials,
             2 at once, median stopping on (a study this small prunes no
             trial, so the pruning path is held only by the CPU tests);
             on a one-rank NCCL world (its own process) the multichip row
             at JAX's defaults, 2 steps, 1 window, held also by the dry
             run's assertions (``entry.check_timed_row``). Every row
             without ``error``, with ``bench.py``'s key set, ``value > 0``
             and ``platform`` "gpu", is printed, then the summary line.
             Runs after 19g, before 19h;
19i. moe  — GPT-small with JAX's MoE fields (8 experts, top-2; seeded
             weights) served paged by the engine (8 slots) with the 8
             prompts, 32 new tokens each, admitted as one wave
             (``AdmitGate``: every row of a call shares an expert's
             capacity), once through the kernels and once through the plain
             writes: the same greedy tokens, ``kv_block_update_pair`` 12 a
             decode step; then 3 AdamW steps of ``GptLM(decode=False)`` at
             b 8 x 256 through the flash kernels (12 launches of each a step,
             and the counted reference step) and through the plain
             attention: finite losses within 0.02 at step 1 and 0.05 over
             the run;
19j. ring  — ``parallel.ring_attention``'s block steps at ring size 4 in
             one process (no collective): the bench GPT's attention (b 2,
             h 16, d 64, bf16, causal) over L 4096 = 4 x 1024, forward
             (``ring_forward``: 4 flash forwards a query block at its
             global offsets, merged by log-sum-exp in f32) and backward
             (``ring_backward`` from the global out and lse), 16 launches of
             each flash kernel, against ``flash_attention`` over the whole
             sequence (within 2% of the largest value, relative: out in
             f32 against the whole call's f32 out, and rounded to bf16
             against its bf16 out); both times; then ``ring_attention``
             over a one-rank NCCL group against ``flash_attention``: the
             same bits on out (the f32 merge of one block, rounded once),
             and on the gradients against ``flash_attention_bwd`` run from
             the same f32 out;
19k. dist1 — on that one-rank NCCL world, the composite dp x fsdp x tp x
             pp step (every axis 1; JAX's ``CompositeConfig`` defaults, 4
             microbatches of 8) in each gather mode and the FSDP step
             (JAX's ``FsdpConfig`` defaults, batch 8) in both, 3 SGD steps
             each: falling losses, ``eager`` and ``overlap`` the same bits
             in both steps, ``amortized`` within 1e-5 of ``eager``; step ms.
             Phases 19i-19k run after 24a, before kv_probe;
23a. serving_drivers — the serving fleet under faults, each run with the
             counts reset just before and read just after: the overload
             driver at GPT-small (``overload_driver.run(tiny=False)``: 3
             replicas of 2 slots on the card, the flood at 2.22x the
             batch capacity, ``client_abandon``, the ``slow_replica``
             breaker cycle and ``crash_replica_mid_decode`` fired by the
             port's ``ChaosMonkey``; the card's allocated bytes, cuBLAS's
             workspaces cleared, back within 16 MiB of before once it
             returns); the Pod-path fleet at
             GPT-small (two replicas with ``client=PodClient()``,
             unroutable until ``bind_pending`` binds each; both serve two of
             phase 3's prompts with its paged tokens and each other's; a
             deleted Pod drains its replica with reason ``preempted`` and
             comes back as a new Pod that serves the same tokens after its
             bind; ``fleet_replica_cold_start_seconds`` counts 3); the
             fleet, observability and serving drivers at JAX's defaults
             (GPT-tiny, BERT-tiny). Every driver must return ``ok``; each
             GPT run ``kv_block_update_pair`` one a layer a decode step
             (12 at GPT-small) and no other KV write, the serving driver's
             BERT one ``flash_fwd`` a layer a forward. Runs after 5g;
24a. monitoring — the port's monitoring driver at GPT-small
             (``monitoring_driver.run(tiny=False)``), the counts reset just
             before and read just after: a 2-replica Pod-path fleet whose
             Pods carry ``metrics_url``'s scrape annotations, and two ops
             processes of the port's metrics, scraped by one
             ``MonitoringPlane`` (three targets up, ``/federate`` parsed);
             a slowed fleet fires the ``TtftBurn`` burn-rate alert (ONE
             deduplicated Warning Event, count >= 2) and
             ``SLOAutoscaler(source=FederatedWindowSource(plane.tsdb))``
             scales it 2 → 3; fast traffic resolves the alert (one Normal
             ``TtftBurnResolved``); the platform overview reads the three
             targets and a federated TTFT p99; ``kv_block_update_pair`` 12
             a decode step and no other KV write. Prints the fire and
             resolve ticks, the Event count, the scale-up's cold start and
             the fast and slowed TTFT p50. Runs after 23a;
21a. tiny_paths — the entry points that run the flash kernels at head_dim
             16, each with the counts reset just before and read just
             after: ``GptConfig.tiny()`` trained 3 AdamW steps through the
             kernels (2 launches of each a step, and the counted reference
             step) and through ``causal_plain_attention`` (losses within
             0.02 at step 1 and 0.05 over the run);
             ``bert_served_model(tiny=True)``'s ``predict`` against the
             same weights with ``full_attention`` (logits within 0.1; one
             ``flash_fwd`` a layer); ``autotune_gpt_quick`` on the card
             (its measured candidates through the kernels, 2 launches of
             each a step); ``entry._bert_phase`` on the one-rank NCCL
             world (``BertConfig.tiny()``, 4 heads of 16, f32: the SIMT
             kernels; loss within 1e-4 of one process's). Runs after 19k;
20a. classifier_mesh — on a fresh one-rank NCCL world, the bench ResNet-50
             (batch 256 of 224², s2d stem, fused blocks, SGD-momentum)
             through ``ClassifierTask(mesh, FSDP_RULES)`` (the parameters
             JAX's shards, gathered by ``all_gather`` each step, the
             optimizer on the shards), 4 steps, and 4 steps of the
             mesh-less task from the same seeded weights: finite losses,
             ``fused_bottleneck`` 12 and ``fused_transition`` 4 launches a
             step in both, losses and parameters within 1e-5 / 2e-5 of
             the mesh-less run (whether they are the same bits is
             printed); cuDNN held to its deterministic algorithms, so a
             second mesh-less run must repeat the first bit for bit;
             step ms and images/s of each run;
20b. elastic1 — on a fresh one-rank NCCL world, ``ElasticTrainer`` with
             ``CompositeWorkload`` (JAX's ``CompositeConfig`` defaults), a
             ``StepClock``, a ``WorkerBeacon`` and a ``GoodputLedger``,
             offers scripted on the drivers' in-memory cluster: (pp 1,
             V 1) drained after its third step, (pp 1, V 2) lost at step 5
             (2 steps past the periodic checkpoint at 3), (pp 1, V 1) to
             step 12: completed, 1 preemption survived, 2 steps replayed,
             losses within 1e-3 of an uninterrupted run on the card,
             goodput fractions summing to exactly 1.0 and reconstructing
             the wallclock within 5%; step ms and the decomposition.
             Phases 20a-20b run after 19k, before kv_probe;
20. kv_probe — ``kubeflow_tpu_torch.e2e.kv_update_probe``: the KV writes
             alone (contiguous and paged), the host split of a write's
             call, the decode chunk per token with the writes plain and
             through the kernels (100 calls a time, 4,000 calls a part, 1
             timed chunk a row: fewer repeats than the probe's defaults).
             It runs last: no profiler window follows its launches.

The peaks in every bound and mfu come from the port's catalog
(``kubeflow_tpu_torch.training.flops`` with ``detect_generation()``, which
raises on a card it does not list); ``mfu`` in phases 10 and 14 is the
counted FLOPs of a step over its median time.

The launch counts reported per kernel come from its main-path phase (the
serving phases 3-5 for the KV writes, ``train`` for flash attention,
``resnet_train`` for the fused blocks, ``probe`` for the streaming
copies): they are reset just before the run and read just after. Phases
5a and 5c reset and read them around their own runs too, and print them
on their own lines; phases 5d-5g reset and read them around each run,
print them on each run's own line, and their counts are added to the
kernels line's (the draft's and the decode side's KV writes,
distillation's flash launches, the fleet replicas' KV writes), as are
phase 19b's fused-block launches (both of its runs), phase 19d's flash
launches and phase 19e's KV and flash launches (BERT's, the engine
pass's, distillation's, the spec draft's and the fleet's decode pool's)
phase 22a's fused-block and flash launches (its sweeps' candidates and
runs), phase 19i's KV and flash launches (its kernel runs), phase 19j's
flash launches (the block steps' checked run and the one-rank ring),
phase 21a's flash launches (its four paths),
phase 23a's KV and flash launches (its drivers' and the Pod fleet's),
phase 24a's KV launches (the monitoring driver's fleet) and
phase 20a's fused-block launches (its mesh run):
that line's count is
then a sum over several runs, and each path's own count is on its run's
line. The fused-block
kernels' entries in the kernels line sum their per-call times over the blocks of one training step (2, 3, 5
and 2 identity blocks; one of each stage head); their ``max_abs_err`` is
the largest over the shapes. Every device time read from torch.profiler
comes from a window that kept the records it is read from: a window that
lost some (a launch call with no kernel record) is taken again, and the
line ``profiler_windows`` before the kernels line lists every window's
launch calls and lost records. GPT-small's seeded weights are drawn once
a seed (``small_params``) and shared, read-only, by every phase that
serves or probes GPT-small, and ``generate()``'s reference tokens for a
long prompt once a prompt (``generate_ref``). Every phase runs on every
call; the last line is ``{"ok": true, "device": {...}}``.
"""

from __future__ import annotations

import dataclasses
import gc
import json
import os
import shutil
import subprocess
import sys
import tempfile
import threading
import time
import urllib.error
import urllib.request
from collections import Counter

import numpy as np
import torch

#: the card's peaks from the port's catalog, set in main()
HBM_BYTES_PER_S = BF16_FLOPS_PER_S = float("nan")
MAX_NEW = 32
PROMPT_LENS = (16, 23, 40, 64, 97, 128, 200, 256)
#: the over-bucket request's prompt: above the largest prefill bucket (256)
LONG_PROMPT = 600
#: serve_chunked's long prompt: 6 chunks of 256, and 1500 + 32 <= 2048
CHUNKED_PROMPT = 1500
#: each serving layout's KV write: the pair kernel of its decode steps, and
#: the one-array wrapper that must not launch
SERVE_PAIRS = {"paged": ("kv_block_update_pair", "kv_block_update"),
               "contiguous": ("kv_row_update_pair", "kv_row_update"),
               "int8": ("kv_block_update_quant_pair", "kv_block_update_quant")}


def smi() -> str:
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout.strip().splitlines()[0]


def emit(**obj) -> None:
    print(json.dumps(obj), flush=True)


def cleanup() -> None:
    gc.collect()
    if torch.cuda.is_available():
        torch.cuda.empty_cache()


def cuda_ms(fn, iters: int = 200, warmup: int = 10) -> float:
    """Mean device time per call over ``iters`` back-to-back calls (CUDA
    events around the loop)."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / iters


def profiled(run, activities=("cuda",)):
    """``run()`` (which must end in a device synchronize) twice under one
    torch.profiler session: a warm-up cycle, whose trace is dropped, then the
    recorded cycle. Returns the profiler and the recorded cycle's host ms.
    The window's record counts go to ``WINDOWS`` (``window_stats``).

    Without the warm-up cycle a window can lose its first launches, the more
    the longer the process has run (torch 2.11 with CUDA 12.8 on an H100).
    With it a window still loses device records: a launch call is in the
    trace and its kernel is not. Of 10-launch windows on an H100 about one
    in nine lost some and one in a hundred all (``e2e/profiler_records.py``);
    a pause before the stop did not change that, and CPU activity beside
    CUDA's cut the partial losses, not the whole ones."""
    from torch.profiler import ProfilerActivity, profile, schedule

    acts = [{"cpu": ProfilerActivity.CPU, "cuda": ProfilerActivity.CUDA}[a] for a in activities]
    with profile(activities=acts, schedule=schedule(wait=0, warmup=1, active=1, repeat=1)) as prof:
        run()
        prof.step()
        t0 = time.perf_counter()
        run()
        wall_ms = (time.perf_counter() - t0) * 1e3
        prof.step()
    WINDOWS.append(window_stats(prof))
    return prof, wall_ms


#: how many windows a measurement may take
TAKES = 8
#: one entry per profiler window of this run (``window_stats``)
WINDOWS: list = []
T_START = time.perf_counter()


def retake_pause(take: int) -> None:
    """The pause before a measurement's window ``take`` (none before the
    first): 1 s, doubling up to 8 s, so TAKES windows span about 40 s. Lossy
    windows come in runs: one run on an H100 lost a record in each of 8
    windows over 7 s, another in 10 windows over 9 s."""
    if take:
        time.sleep(min(2.0 ** (take - 1), 8.0))


def window_stats(prof) -> dict:
    """A recorded window's kernel-launch calls and how many of them have no
    device record (``lost``: the profiler dropped it; a launch always runs
    its kernel), and the process's age."""
    from kubeflow_tpu_torch.e2e.profiler_records import lost_records

    launches, lost = lost_records(prof)
    return dict(age_s=round(time.perf_counter() - T_START, 3), launches=launches, lost=lost)


def whole(stats: dict, launches: int) -> bool:
    """Whether a window kept every device record of at least ``launches``
    kernel launches."""
    return stats["lost"] == 0 and stats["launches"] >= launches


def whole_profile(run, activities, launches: int):
    """``profiled``, taken again (up to TAKES times) while the window lost a
    device record or holds fewer than ``launches`` launch calls. Returns the
    first whole window, else the last, for the caller's exact checks."""
    for take in range(TAKES):
        retake_pause(take)
        prof, wall_ms = profiled(run, activities)
        if whole(WINDOWS[-1], launches):
            break
    return prof, wall_ms


def device_events(prof) -> list:
    """(name, device ms) of each kernel, copy and memset in a torch.profiler
    trace. Spans of user annotations on the device timeline
    (``Optimizer.step#...``) are left out: they cover kernels counted on
    their own."""
    from torch.autograd import DeviceType

    return [(e.name, e.time_range.elapsed_us() / 1e3) for e in prof.events()
            if e.device_type == DeviceType.CUDA and not e.is_user_annotation]


def cuda_kernel_ms(prof, match: str) -> list:
    """Device ms of each kernel in a trace whose name holds ``match``."""
    return [ms for name, ms in device_events(prof) if match in name]


def kernel_device_ms(fn, match: str, iters: int = 50, per_call: int = 1) -> float:
    """Mean execution time on the device of the kernels whose name holds
    ``match``, per call of ``fn`` (torch.profiler): the kernel alone, without
    the host-side launch cost that ``cuda_ms`` of back-to-back calls
    includes. Each call launches ``per_call`` such kernels: a window with
    more fails the phase, and so does one that kept every record and holds
    none (another kernel ran). Windows that lost records are taken again, up
    to TAKES, and the mean is over the records of the takes once they hold
    ``iters`` calls' worth (each record is one launch's own time)."""
    def run():
        for _ in range(iters):
            fn()
        torch.cuda.synchronize()

    want = iters * per_call
    seen = []
    for take in range(TAKES):
        retake_pause(take)
        ms = cuda_kernel_ms(profiled(run)[0], match)
        if len(ms) == want:
            return sum(ms) / iters
        if len(ms) > want or (not ms and whole(WINDOWS[-1], want)):
            raise AssertionError(f"a window holds {len(ms)} {match} kernels for "
                                 f"{iters} calls of {per_call}: {WINDOWS[-1]}")
        seen += ms
        if len(seen) >= want:
            return sum(seen) / len(seen) * per_call
    raise AssertionError(f"profiler saw {len(seen)} {match} kernels in {TAKES} windows of "
                         f"{iters} calls of {per_call}: {WINDOWS[-TAKES:]}")


def device_ms_by_kernel(prof) -> dict:
    """Device time (ms) per kernel name in a torch.profiler trace."""
    by_name = {}
    for name, ms in device_events(prof):
        by_name[name] = by_name.get(name, 0.0) + ms
    return by_name


#: runtime calls that put work on the device: kernel launches (the runtime's
#: and the driver's), copies and memsets
DEVICE_WORK = ("aunch", "emcpy", "emset")


def whole_calls(prof, iters: int) -> list:
    """(device ms, kernel names) of each call of a window of ``iters`` calls
    that kept every device record of its own. The window's runtime calls
    that put work on the device, in the order they were made, are split
    into ``iters`` runs of the same calls, one run a call; a call whose
    records were all kept is whole, even where another call of the window
    lost one. A window holding a device record of no such runtime call, or
    whose runtime calls do not split so, gives none."""
    from torch.autograd import DeviceType

    events = prof.profiler.kineto_results.events()
    records = {}
    for e in events:
        if e.device_type() == DeviceType.CUDA and not e.is_user_annotation():
            records.setdefault(e.correlation_id(), []).append((e.name(), e.duration_ns() / 1e6))
    issued = sorted((e.start_ns(), e.correlation_id(), e.name()) for e in events
                    if e.device_type() == DeviceType.CPU
                    and any(w in e.name() for w in DEVICE_WORK))
    per_call, rest = divmod(len(issued), iters)
    if not per_call or rest or set(records) - {c for _, c, _ in issued}:
        return []
    runs = [issued[i * per_call:(i + 1) * per_call] for i in range(iters)]
    if len({tuple(name for _, _, name in run) for run in runs}) != 1:
        return []
    calls = []
    for run in runs:
        if all(c in records for _, c, _ in run):
            kept = [r for _, c, _ in run for r in records[c]]
            calls.append((sum(ms for _, ms in kept), {name for name, _ in kept}))
    return calls


def library_device_ms(fn, iters: int = 20):
    """Device ms per call of every CUDA kernel, copy and memset that ``fn``
    launches (a library call's yardstick, by the profiler method of
    ``kernel_device_ms``), and the sorted names of those kernels. Only
    whole calls count (``whole_calls``): a window that lost a record (phase
    resnet_kernels' cuDNN composite once lost 7 of 10 calls, three windows
    running; a torch.mul lost 1 of 10 in 8 windows running) still gives the
    calls it kept whole. Windows are taken, up to TAKES, until they hold
    ``iters`` whole calls, and the time is over the whole calls they hold."""
    def run():
        for _ in range(iters):
            fn()
        torch.cuda.synchronize()

    total_ms, calls, names = 0.0, 0, set()
    for take in range(TAKES):
        retake_pause(take)
        for ms, kernels in whole_calls(profiled(run)[0], iters):
            total_ms += ms
            calls += 1
            names |= kernels
        if calls >= iters:
            return total_ms / calls, sorted(names)
    raise AssertionError(f"profiler saw {calls} whole calls in {TAKES} windows of {iters} "
                         f"calls: {WINDOWS[-TAKES:]}")


def max_abs_err(a: torch.Tensor, b: torch.Tensor) -> float:
    return float((a.float() - b.float()).abs().max())


# -- phase 2 -------------------------------------------------------------------

KV_SOURCE = "kubeflow_tpu_torch/ops/csrc/kv_cache.cu"
KV_REPLACES = {
    "kv_row_update_pair": "kubeflow_tpu/ops/kv_cache.py:45 (_kernel, pallas_call :93)",
    "kv_block_update_pair": "kubeflow_tpu/ops/kv_cache.py:117 (_paged_kernel, pallas_call :168)",
    "kv_block_update_quant_pair":
        "kubeflow_tpu/ops/kv_cache.py:222 (_paged_quant_kernel, pallas_call :277)",
}
#: profiler names of the KV writes' designs (csrc/kv_cache.cu): 0 is the
#: replaced one-array kernel, 1 the pair
KV_DESIGN_MATCH = {
    "kv_row_update_pair": {0: "kv_row_update_kernel", 1: "kv_row_update_pair_kernel"},
    "kv_block_update_pair": {0: "kv_block_update_kernel", 1: "kv_block_update_pair_kernel"},
    "kv_block_update_quant_pair": {0: "kv_block_update_quant_kernel",
                                   1: "kv_block_update_quant_pair_kernel"},
}


def kv_refusals(kc, cache, arena, qarena, scales, new, cur, tables, T) -> int:
    """Every refusal of the pair wrappers, on CUDA tensors; returns how many
    were checked."""
    S = cache.shape[0]
    wide = torch.zeros((2 * S,) + cache.shape[1:], dtype=cache.dtype, device=cache.device)
    rows = [
        ("the same cache twice", (cache, cache), (new, new)),
        ("overlapping caches", (wide[:S], wide[S - 1:2 * S - 1]), (new, new)),
        ("caches of different shapes", (cache, wide[:S - 1]), (new, new)),
        ("caches of different dtypes", (cache, cache.float()), (new, new)),
        ("a non-contiguous cache", (cache, wide[::2]), (new, new)),
        ("contiguous rows of two dtypes", (cache, cache.clone()), (new, new.float())),
        ("a cache on the CPU", (cache, cache.cpu()), (new, new)),
    ]
    for label, caches, news in rows:
        refused(lambda: kc.kv_row_update_pair(*caches, *news, cur), f"kernels: {label}")
    N = arena.shape[0]
    big = torch.zeros((2 * N,) + arena.shape[1:], dtype=arena.dtype, device=arena.device)
    cases = [
        ("the same arena twice", kc.kv_block_update_pair, (arena, arena)),
        ("overlapping arenas", kc.kv_block_update_pair, (big[:N], big[N - 1:2 * N - 1])),
        ("arenas of different shapes", kc.kv_block_update_pair, (arena, big[:N - 1])),
        ("arenas of different dtypes", kc.kv_block_update_pair, (arena, arena.float())),
        ("a non-contiguous arena", kc.kv_block_update_pair, (arena, big[::2])),
        ("the same scale arena twice", kc.kv_block_update_quant_pair,
         (qarena, scales, qarena.clone(), scales)),
        ("the same int8 arena twice", kc.kv_block_update_quant_pair,
         (qarena, scales, qarena, scales.clone())),
        ("int8 arenas of different shapes", kc.kv_block_update_quant_pair,
         (qarena, scales, qarena[:N - 1].clone(), scales[:N - 1].clone())),
        ("a non-contiguous scale arena", kc.kv_block_update_quant_pair,
         (qarena, scales, qarena.clone(), torch.zeros_like(scales.expand(-1, -1, -1, 2))[..., :1])),
    ]
    for label, fn, arenas in cases:
        refused(lambda: fn(*arenas, new, new, cur, tables, max_seq=T), f"kernels: {label}")
    refused(lambda: kc.kv_block_update_pair(arena, arena.clone(), new, new.float(), cur,
                                            tables, max_seq=T), "kernels: rows of two dtypes")
    return len(rows) + len(cases) + 1


def kernel_phase(card: str):
    """The KV-cache writes at GPT-small serving shapes, each held bit for bit
    against its plain version; per layer (K and V) the call ms, device ms,
    plain ms, a library yardstick, the bytes bound; the launch floor; the
    pairs' refusals; every design of each write on this call."""
    from kubeflow_tpu_torch.ops import kv_cache as kc

    dev = "cuda"
    g = torch.Generator().manual_seed(0)
    S, T, H, D, bt = 8, 2048, 12, 64, 16
    mb, n_layers = T // bt, 12
    N = S * mb + 1
    trash = N - 1
    # slots 4 and 5 are past the end (no-op); slot 6's table is all trash
    cur = torch.tensor([0, 5, 17, 2047, 2048, 3000, 100, 999], dtype=torch.int32)
    tables = torch.randperm(N - 1, generator=g)[: S * mb].reshape(S, mb).int()
    tables[6, :] = trash
    valid = cur < T
    n_valid = int(valid.sum())
    new = torch.randn(S, H, D, generator=g).to(dev, torch.bfloat16)
    cache = torch.randn(S, T, H, D, generator=g).to(dev, torch.bfloat16)
    arena = torch.randn(N, bt, H, D, generator=g).to(dev, torch.bfloat16)
    qarena = torch.randint(-127, 128, (N, bt, H, D), generator=g, dtype=torch.int8).to(dev)
    scales = torch.rand(N, bt, H, 1, generator=g).to(dev)
    # V's rows, arenas and cache
    v_new = torch.randn(S, H, D, generator=g).to(dev, torch.bfloat16)
    v_arena = torch.randn(N, bt, H, D, generator=g).to(dev, torch.bfloat16)
    v_qarena = torch.randint(-127, 128, (N, bt, H, D), generator=g, dtype=torch.int8).to(dev)
    v_scales = torch.rand(N, bt, H, 1, generator=g).to(dev)
    v_cache = torch.randn(S, T, H, D, generator=g).to(dev, torch.bfloat16)
    cur_d, tables_d = cur.to(dev), tables.to(dev)
    rows_v = torch.arange(S)[valid].to(dev)
    pos_v = cur[valid].long()
    blk_v = tables[torch.arange(S)[valid], pos_v // bt].long().to(dev)
    off_v = (pos_v % bt).to(dev)
    pos_v = pos_v.to(dev)
    new_v, v_new_v = new[valid.to(dev)], v_new[valid.to(dev)]
    row = H * D * 2
    # bytes each write needs: the S cursors are read; only the n_valid slots
    # whose cursor is in range read their table entry (paged) and their row
    # of `new`, and write one cache or arena row (and scale)
    cursor_bytes, entry_bytes = S * 4, n_valid * 4

    floor_call = lambda: kc.kv_launch_floor(arena, S)
    floor = dict(floor_ms=cuda_ms(floor_call),
                 floor_device_ms=kernel_device_ms(floor_call, "kv_launch_floor_kernel"))
    emit(phase="kernels", kernel="kv_launch_floor", card=card, grid=S,
         kernel_ms=floor["floor_ms"], kernel_device_ms=floor["floor_device_ms"])

    results = {}

    def record(name, err, ms, dev_ms, plain_ms, library_ms, nbytes, **extra):
        bound_ms = nbytes / HBM_BYTES_PER_S * 1e3
        results[name] = dict(name=name, route="cuda", source=KV_SOURCE,
                             replaces=KV_REPLACES[name], max_abs_err=err, ms=ms,
                             plain_ms=plain_ms, bound_ms=bound_ms, bound_by="bytes",
                             library_ms=library_ms, device_ms=dev_ms, **floor)
        emit(phase="kernels", kernel=name, card=card, bit_equal=err == 0.0,
             kernel_ms=ms, kernel_device_ms=dev_ms, plain_ms=plain_ms,
             library_ms=library_ms, bound_ms=bound_ms, bytes=nbytes,
             device_over_floor=dev_ms / floor["floor_device_ms"], **floor, **extra)

    def pair_case(name, start, pair, plain, single, cfg, nbytes, library=None):
        """One pair: bit-equal to its plain version twice, and so are
        two calls of the one-array wrapper (the same kernel over one array);
        every design through ``cfg(design, arenas)`` bit-equal too; the
        times per layer of the pair, of two one-array calls, of each design
        on the device, of the plain version and of ``library`` (two calls)."""
        want = plain([t.clone() for t in start])
        for fn, label in ((pair, name), (single, f"{name}'s one-array wrapper")):
            for _ in range(2):
                got = [t.clone() for t in start]
                fn(got)
                torch.cuda.synchronize()
                if not all(torch.equal(x, y) for x, y in zip(got, want)):
                    raise AssertionError(f"{label} differs from its plain version")
        designs = {}
        for design, match in KV_DESIGN_MATCH[name].items():
            got = [t.clone() for t in start]
            cfg(design, got)
            torch.cuda.synchronize()
            if not all(torch.equal(x, y) for x, y in zip(got, want)):
                raise AssertionError(f"{name} design {design} differs from the plain version")
            work = [t.clone() for t in start]
            per_call = 2 if design == 0 else 1
            designs[design] = kernel_device_ms(lambda: cfg(design, work), match,
                                               per_call=per_call)
        del got, want
        work = [t.clone() for t in start]
        call = lambda: pair(work)
        ms = cuda_ms(call)
        dev_ms = kernel_device_ms(call, name)
        two = lambda: single(work)
        single_ms = cuda_ms(two)
        single_dev_ms = kernel_device_ms(two, name, per_call=2)  # the same kernel, one array
        plain_ms = cuda_ms(lambda: plain(work), iters=50)
        extra = {}
        library_ms = None
        if library is not None:
            library_ms = cuda_ms(library)
            one_dev_ms, lib_names = library_device_ms(lambda: library(1))
            extra = dict(library="index_put_ x2 (in-range rows, host-computed indices)",
                         library_device_ms=2 * one_dev_ms,
                         library_kernels=[n[:90] for n in lib_names],
                         device_ms_over_library=dev_ms / (2 * one_dev_ms))
        record(name, 0.0, ms, dev_ms, plain_ms, library_ms, nbytes, per="layer (K and V)",
               launches_per_token=n_layers, single_x2_ms=single_ms,
               single_x2_device_ms=single_dev_ms, replaced_device_ms=designs[0],
               design_device_ms=designs, device_over_replaced=dev_ms / designs[0], **extra)
        results[name].update(per="layer (K and V)", replaced_device_ms=designs[0])

    def row_index_put_x2(n=2):
        cache.index_put_((rows_v, pos_v), new_v)
        if n == 2:
            v_cache.index_put_((rows_v, pos_v), v_new_v)

    pair_case(
        "kv_row_update_pair", [cache, v_cache],
        lambda t: kc.kv_row_update_pair(*t, new, v_new, cur_d),
        lambda t: kc.kv_row_update_pair_plain(*t, new, v_new, cur_d),
        lambda t: (kc.kv_row_update(t[0], new, cur_d), kc.kv_row_update(t[1], v_new, cur_d)),
        lambda d, t: kc.kv_row_update_cfg(d, *t, new, v_new, cur_d),
        cursor_bytes + 2 * 2 * n_valid * row, library=row_index_put_x2)

    def index_put_x2(n=2):
        arena.index_put_((blk_v, off_v), new_v)
        if n == 2:
            v_arena.index_put_((blk_v, off_v), v_new_v)

    pair_case(
        "kv_block_update_pair", [arena, v_arena],
        lambda t: kc.kv_block_update_pair(*t, new, v_new, cur_d, tables_d, max_seq=T),
        lambda t: kc.kv_block_update_pair_plain(*t, new, v_new, cur_d, tables_d, max_seq=T),
        lambda t: (kc.kv_block_update(t[0], new, cur_d, tables_d, max_seq=T),
                   kc.kv_block_update(t[1], v_new, cur_d, tables_d, max_seq=T)),
        lambda d, t: kc.kv_block_update_cfg(d, *t, new, v_new, cur_d, tables_d, max_seq=T),
        cursor_bytes + entry_bytes + 2 * 2 * n_valid * row, library=index_put_x2)
    pair_case(
        "kv_block_update_quant_pair", [qarena, scales, v_qarena, v_scales],
        lambda t: kc.kv_block_update_quant_pair(*t, new, v_new, cur_d, tables_d, max_seq=T),
        lambda t: kc.kv_block_update_quant_pair_plain(*t, new, v_new, cur_d, tables_d,
                                                      max_seq=T),
        lambda t: (kc.kv_block_update_quant(t[0], t[1], new, cur_d, tables_d, max_seq=T),
                   kc.kv_block_update_quant(t[2], t[3], v_new, cur_d, tables_d, max_seq=T)),
        lambda d, t: kc.kv_block_update_cfg(d, t[0], t[2], new, v_new, cur_d, tables_d,
                                            max_seq=T, k_scales=t[1], v_scales=t[3]),
        cursor_bytes + entry_bytes + 2 * n_valid * (row + H * D + H * 4))
    n_refused = kv_refusals(kc, cache, arena, qarena, scales, new, cur_d, tables_d, T)
    emit(phase="kernels", kernels=sorted(results), card=card, refused=n_refused)
    return results


# -- phases 3-5 ----------------------------------------------------------------

def post(port: int, prompt) -> list:
    req = urllib.request.Request(
        f"http://127.0.0.1:{port}/v1/models/gpt:predict",
        data=json.dumps({"instances": [list(map(int, prompt))]}).encode(),
        headers={"Content-Type": "application/json"}, method="POST")
    with urllib.request.urlopen(req, timeout=600) as resp:
        body = json.loads(resp.read())
    return body["predictions"][0]


def admitted() -> int:
    """Requests admitted to a slot since the last reset (the count of
    ``serving_queue_wait_seconds``), over every engine of the process."""
    from kubeflow_tpu_torch.runtime.metrics import METRICS

    snap = METRICS.histogram_counts("serving_queue_wait_seconds")
    return snap[2] if snap else 0


def post_all(port: int, prompts, label: str, staggered: bool = False) -> list:
    """Every prompt posted at once, one thread each; the predictions. With
    ``staggered``, each next thread starts once the request before it has a
    slot (a fleet's router reads the slot gauges, so the prompts then
    spread over the replicas)."""
    out = [None] * len(prompts)
    errors = []

    def one(i):
        try:
            out[i] = post(port, prompts[i])
        except Exception as e:  # surfaced below, after every thread joined
            errors.append(e)

    threads = [threading.Thread(target=one, args=(i,)) for i in range(len(prompts))]
    base = admitted()
    for i, t in enumerate(threads):
        t.start()
        deadline = time.monotonic() + 60
        while staggered and admitted() < base + i + 1 and time.monotonic() < deadline:
            time.sleep(0.001)
    for t in threads:
        t.join(timeout=900)
    if errors or any(o is None for o in out):
        raise RuntimeError(f"{label}: requests failed: {errors}")
    return out


def generated(label: str, prompts, out, vocab: int) -> list:
    """The generated tokens of each prediction, after checking its shape,
    its echo of the prompt and its vocabulary."""
    gen = []
    for p, o in zip(prompts, out):
        if o[:len(p)] != list(map(int, p)) or len(o) != len(p) + MAX_NEW:
            raise AssertionError(f"{label}: malformed prediction")
        toks = o[len(p):]
        if not all(0 <= t < vocab for t in toks):
            raise AssertionError(f"{label}: token outside the vocabulary")
        gen.append(toks)
    return gen


def ttft_ms() -> list:
    """(prompt tokens, ms from submit to first token) of every finished
    ``serving.request`` span that reached its first token."""
    from kubeflow_tpu_torch.runtime.tracing import TRACER

    out = []
    for span in TRACER.finished_spans("serving.request"):
        ev = {e["name"]: e["timeUnixNano"] for e in span.events}
        if "first_token" in ev:
            out.append((span.attributes["prompt_tokens"],
                        (ev["first_token"] - span.start_ns) / 1e6))
    return out


#: the largest top-2 logit gap of generate() at which a bf16 route may pick
#: the other token (a near-tie), in logits
NEAR_TIE = 0.05
#: how much less often bf16 BERT with the flash kernel may agree with the f32
#: model's argmax than bf16 BERT with full_attention does (10 of 1024 positions)
BF16_ARGMAX_SLACK = 0.01


def top2_gap(cfg, params, prompt, path, step: int) -> float:
    """The top-2 logit gap of ``generate()``'s model (one prefill, then
    single-token steps) at ``step`` of a greedy run that emitted ``path``."""
    from kubeflow_tpu_torch.models.gpt import GptLM, _fresh_cache

    with torch.no_grad():
        model = GptLM.bind(cfg, params, decode=True)
        cache = _fresh_cache(cfg, 1, "cuda")
        logits = model(torch.as_tensor(prompt[None]).cuda(), cache)[0, -1]
        for t in path[:step]:
            logits = model(torch.tensor([[t]], dtype=torch.int32, device="cuda"), cache)[0, -1]
        top2 = torch.topk(logits.float(), 2).values
    return float(top2[0] - top2[1])


#: GPT-small's seeded weights on the card, by seed (``small_params``)
_SMALL_PARAMS: dict = {}
#: generate()'s greedy tokens, by (weights, prompt bytes) (``generate_ref``)
_GENERATED: dict = {}


def small_params(seed: int = 0):
    """GPT-small's seeded weights on the card, drawn once a seed and shared,
    read-only, by every phase that serves or probes GPT-small (each phase
    used to draw its own: the same bits, drawn on the host again)."""
    from kubeflow_tpu_torch.models.gpt import GptConfig, init_params

    if seed not in _SMALL_PARAMS:
        _SMALL_PARAMS[seed] = init_params(GptConfig.small(), seed=seed, device="cuda")
    return _SMALL_PARAMS[seed]


def generate_ref(cfg, params, prompt) -> list:
    """The port's ``generate()`` greedy tokens (``MAX_NEW``) for ``prompt``,
    run once a (weights, prompt): the long prompts of phases 3-5a are held
    to the same reference in several layouts."""
    from kubeflow_tpu_torch.models.gpt import generate

    key = (id(params), np.asarray(prompt).tobytes())
    if key not in _GENERATED:
        _GENERATED[key] = generate(cfg, params, prompt[None], MAX_NEW,
                                   device="cuda")[0, len(prompt):].tolist()
    return _GENERATED[key]


def hold_to_generate(label: str, cfg, params, prompt, toks, card: str,
                     exact: bool = False) -> dict:
    """``toks`` (a served request's generated tokens) against the port's
    ``generate()`` on the same weights. Equal passes; with ``exact`` (the
    static route, which is ``generate()`` itself) nothing else does. Where a
    chunked prefill's tokens differ (bf16 sums in another order than
    generate()'s one prefill), the first differing step is found and
    generate()'s own logits there are read, step by step as it ran: the
    request passes only if their top-2 gap is under ``NEAR_TIE``."""
    want = generate_ref(cfg, params, prompt)
    if exact and toks != want:
        raise AssertionError(f"{label}: the static route's tokens differ from generate()")
    held = near_tie(label, cfg, params, prompt, toks, want, card)
    return {"equal_to_generate": held.pop("equal"), **held}


def near_tie(label: str, cfg, params, prompt, toks, want, card: str) -> dict:
    """``toks`` against ``want`` (the same request on a reference route):
    equal passes; else the first differing step must be a near-tie of the
    reference, its top-2 logit gap (``top2_gap`` along ``want``) under
    ``NEAR_TIE``."""
    if toks == want:
        return {"equal": True}
    step = next(i for i, (a, b) in enumerate(zip(toks, want)) if a != b)
    gap = top2_gap(cfg, params, prompt, want, step)
    emit(phase=label, card=card, prompt_tokens=len(prompt), differs_at_step=step,
         reference_top2_gap=gap, near_tie_limit=NEAR_TIE)
    if gap >= NEAR_TIE:
        raise AssertionError(f"{label}: a {len(prompt)}-token prompt differs at step {step}, "
                             f"where the reference's top-2 logit gap is {gap} (not a near-tie)")
    return {"equal": False, "first_differing_step": step, "reference_top2_gap": gap}


def serve(prompts, card: str, label: str, long_prompt=None, draft=None, **kw):
    """GPT-small behind ModelServer (``draft(cfg, params)``, where given,
    makes its speculative draft, ``SPEC_K`` a round); one warm-up request,
    then every count reset and the 8 prompts sent concurrently. Then, after the counts are
    read, ``long_prompt`` (over the largest prefill bucket) alone: it must
    be served and held to the port's ``generate()`` on the same weights
    (``hold_to_generate``): by chunked prefill with the default chunk, by
    the static ``generate()`` path with ``prefill_chunk=0``, which must
    equal it exactly. Returns
    (generated tokens per prompt, launch counts of the run, the run's
    stats: decode steps, spec rounds and drafted/accepted tokens, tokens/s,
    TTFT p50)."""
    from kubeflow_tpu_torch.models.gpt import GptConfig
    from kubeflow_tpu_torch.ops import kv_cache as kc
    from kubeflow_tpu_torch.runtime.metrics import METRICS
    from kubeflow_tpu_torch.runtime.tracing import TRACER
    from kubeflow_tpu_torch.serving.server import ModelServer, gpt_served_model

    vocab = GptConfig.small().vocab_size
    model = gpt_served_model(name="gpt", tiny=False, max_new_tokens=MAX_NEW,
                             device="cuda", seed=0, params=small_params(), **kw)
    if draft is not None:
        model = dataclasses.replace(model, spec_draft=draft(model.cfg, model.params),
                                    spec_k=SPEC_K)
    server = ModelServer().add(model)
    httpd = server.serve(0)
    try:
        post(httpd.port, prompts[0][:16])  # warm-up: cuBLAS handles, allocator
        torch.cuda.synchronize()
        kc.reset_launches()
        METRICS.reset()
        TRACER.reset()
        t0 = time.perf_counter()
        out = post_all(httpd.port, prompts, label)
        wall = time.perf_counter() - t0
        counts = dict(kc.LAUNCHES)
        stats = {"steps": int(METRICS.value("serving_decode_steps_total")),
                 "rounds": int(METRICS.value("serving_spec_rounds_total")),
                 "drafted": METRICS.value("serving_spec_tokens_drafted_total"),
                 "accepted": METRICS.value("serving_spec_tokens_accepted_total")}
        gen = generated(label, prompts, out, vocab)
        ttft = [ms for _, ms in ttft_ms()]
        chunk = METRICS.histogram("serving_decode_chunk_seconds")
        stats.update(tokens_per_s=sum(len(t) for t in gen) / wall,
                     ttft_ms_p50=float(np.median(ttft)) if ttft else None)
        emit(phase=label, card=card, requests=len(prompts),
             generated_tokens=sum(len(t) for t in gen), wall_s=wall,
             tokens_per_s=stats["tokens_per_s"], ttft_ms_p50=stats["ttft_ms_p50"],
             decode_chunk_ms_mean=(chunk.sum / chunk.total * 1e3) if chunk.total else None,
             decode_chunks=chunk.total, decode_steps=stats["steps"],
             spec_rounds=stats["rounds"], launches=counts,
             peak_mem_gib=torch.cuda.max_memory_allocated() / 2**30)
        if long_prompt is not None:
            chunks = METRICS.value("serving_prefill_chunks_total")
            t0 = time.perf_counter()
            o = post(httpd.port, long_prompt)
            long_s = time.perf_counter() - t0
            chunks = int(METRICS.value("serving_prefill_chunks_total") - chunks)
            c = model.engine().prefill_chunk
            want_chunks = -(-len(long_prompt) // c) if c else 0
            if chunks != want_chunks:
                raise AssertionError(f"{label}: the over-bucket prompt ran {chunks} prefill "
                                     f"chunks, expected {want_chunks}")
            route = "chunked prefill" if chunks else "static generate()"
            toks = generated(label, [long_prompt], [o], vocab)[0]
            held = hold_to_generate(label, model.cfg, model.params, long_prompt, toks, card,
                                    exact=not chunks)
            emit(phase=label, card=card, over_bucket_prompt=len(long_prompt),
                 route=route, tokens=len(o), wall_s=long_s, **held)
        return gen, counts, stats
    finally:
        httpd.close()
        server.close()
        del model, server
        gc.collect()
        torch.cuda.empty_cache()


# -- phases 5a-5b: chunked prefill, the observability routes ---------------------------

class PrefillGate:
    """Parks the engine's worker after its next prefill call until
    ``release`` is set, so the caller acts between two chunks of a long
    prompt. Installed on ``engine._prefill_model``; ``remove`` restores it."""

    def __init__(self, engine):
        self.engine, self.real = engine, engine._prefill_model
        self.reached, self.release = threading.Event(), threading.Event()
        engine._prefill_model = self

    def __getattr__(self, name):
        return getattr(self.real, name)

    def __call__(self, *args, **kw):
        out = self.real(*args, **kw)
        self.reached.set()
        if not self.release.wait(timeout=300):
            raise RuntimeError("prefill gate never released")
        return out

    def remove(self):
        self.engine._prefill_model = self.real
        self.release.set()


def get_json(port: int, path: str):
    with urllib.request.urlopen(f"http://127.0.0.1:{port}{path}", timeout=120) as resp:
        return json.loads(resp.read())


def obs_phase(card: str, port: int, long_len: int, chunks: int) -> None:
    """The observability routes of the serving port, read after the chunked
    run: the OpenMetrics scrape, the long request's span and its
    ``prefill_chunk`` events, ``/debug/vars`` and ``/debug/stacks``; the SLO
    quantiles through ``METRICS.quantile``."""
    from kubeflow_tpu_torch.runtime.metrics import METRICS

    with urllib.request.urlopen(f"http://127.0.0.1:{port}/metrics", timeout=120) as resp:
        ctype = resp.headers["Content-Type"]
        text = resp.read().decode()
    if not ctype.startswith("application/openmetrics-text; version=1.0.0"):
        raise AssertionError(f"obs: /metrics answered {ctype!r}")
    if not text.endswith("# EOF\n"):
        raise AssertionError("obs: the scrape does not end in # EOF")
    for name in ("serving_ttft_seconds_bucket", "serving_prefill_chunks_total",
                 "process_resident_memory_bytes"):
        if name not in text:
            raise AssertionError(f"obs: {name} is not in the scrape")
    doc = get_json(port, "/debug/traces?name=serving.request&limit=4096")
    spans = doc["resourceSpans"][0]["scopeSpans"][0]["spans"]
    long = [sp for sp in spans if sp["attributes"]["prompt_tokens"] == long_len]
    if len(long) != 1:
        raise AssertionError(f"obs: {len(long)} serving.request spans of {long_len} tokens")
    events = [e["name"] for e in long[0].get("events", [])]
    if events.count("prefill_chunk") != chunks or "chunked_prefill_start" not in events:
        raise AssertionError(f"obs: the long request's events {events}")
    vars_ = get_json(port, "/debug/vars")
    stacks = get_json(port, "/debug/stacks?history=0")
    names = {t["threadName"] for t in stacks["live"]["threads"]}
    if "continuous-batcher" not in names or vars_["pid"] != os.getpid():
        raise AssertionError(f"obs: /debug/stacks threads {sorted(names)}")
    emit(phase="obs", card=card, content_type=ctype, scrape_bytes=len(text),
         request_spans=len(spans), long_request_events=events,
         ttft_s_p50=METRICS.quantile("serving_ttft_seconds", 0.5),
         ttft_s_p99=METRICS.quantile("serving_ttft_seconds", 0.99),
         metric_families=vars_["metric_families"], threads=vars_["threads"],
         rss_gib=vars_["resident_memory_bytes"] / 2**30, debug_sources=vars_["debug_sources"])


def serve_chunked(card: str, layout: str, prompts, short_want, prewarm: bool = False,
                  **kw) -> None:
    """GPT-small behind ModelServer in one KV layout, kernels on, the default
    chunk (256): ``prewarm(16)`` where ``prewarm``, then the 8 prompts and one of
    ``CHUNKED_PROMPT`` tokens (6 chunks) posted at once, 32 new tokens each,
    with every count reset just before and read just after. The pair kernel
    launches 12 times a decode step and the one-array wrapper never; 6
    prefill chunks ran; the 8 outputs equal ``short_want`` (the layout's
    serving run); the KV blocks return; the long prompt is held to
    ``generate()``. Then (paged bf16) the observability routes, the 8
    prompts alone (their TTFT without the long prompt), and a second long
    prompt cancelled by ``cancel_requests(1)`` after its first chunk, which
    fails with RequestCancelled and frees its slot and blocks."""
    from kubeflow_tpu_torch.models.gpt import GptConfig
    from kubeflow_tpu_torch.ops import kv_cache as kc
    from kubeflow_tpu_torch.runtime.metrics import METRICS
    from kubeflow_tpu_torch.runtime.tracing import TRACER
    from kubeflow_tpu_torch.serving.errors import RequestCancelled
    from kubeflow_tpu_torch.serving.server import ModelServer, gpt_served_model

    label = f"serve_chunked_{layout}"
    pair, single = SERVE_PAIRS[layout]
    cfg = GptConfig.small()
    rng = np.random.default_rng(7)
    long_p, long2 = (rng.integers(0, cfg.vocab_size, CHUNKED_PROMPT).astype(np.int32)
                     for _ in range(2))
    model = gpt_served_model(name="gpt", tiny=False, max_new_tokens=MAX_NEW,
                             device="cuda", seed=0, params=small_params(), **kw)
    server = ModelServer().add(model)
    httpd = server.serve(0)
    try:
        torch.cuda.reset_peak_memory_stats()
        eng = model.engine()
        prewarm_s = None
        if prewarm:
            t0 = time.perf_counter()
            eng.prewarm(16)
            torch.cuda.synchronize()
            prewarm_s = time.perf_counter() - t0
        kc.reset_launches()
        METRICS.reset()
        TRACER.reset()
        t0 = time.perf_counter()
        out = post_all(httpd.port, list(prompts) + [long_p], label)
        wall = time.perf_counter() - t0
        counts = dict(kc.LAUNCHES)
        steps = int(METRICS.value("serving_decode_steps_total"))
        chunks = int(METRICS.value("serving_prefill_chunks_total"))
        gen = generated(label, list(prompts) + [long_p], out, cfg.vocab_size)
        ttft = ttft_ms()
        want_chunks = -(-CHUNKED_PROMPT // eng.prefill_chunk)
        if steps == 0 or counts[pair] != cfg.n_layers * steps or counts[single]:
            raise AssertionError(f"{label}: {counts} over {steps} decode steps; expected "
                                 f"{cfg.n_layers} {pair} a step and no {single}")
        if chunks != want_chunks:
            raise AssertionError(f"{label}: {chunks} prefill chunks, expected {want_chunks}")
        if gen[:-1] != short_want:
            raise AssertionError(f"{label}: the 8 short outputs differ from the serving run's")
        if eng.paged and (eng._alloc.used() or METRICS.value(
                "serving_kv_blocks_used", replica=eng.engine_id)):
            raise AssertionError(f"{label}: KV blocks still used after the run")
        held = hold_to_generate(label, cfg, model.params, long_p, gen[-1], card)
        short_ttft = [ms for n, ms in ttft if n != CHUNKED_PROMPT]
        long_ttft = [ms for n, ms in ttft if n == CHUNKED_PROMPT]
        if layout == "paged":
            obs_phase(card, httpd.port, CHUNKED_PROMPT, chunks)
        # the same 8 prompts without the long one: their TTFT alone
        TRACER.reset()
        alone = generated(label, prompts, post_all(httpd.port, prompts, label), cfg.vocab_size)
        if alone != short_want:
            raise AssertionError(f"{label}: the 8 outputs alone differ from the serving run's")
        alone_ttft = [ms for _, ms in ttft_ms()]
        # a second long prompt, cancelled between its first and second chunk
        gate = PrefillGate(eng)
        try:
            fut = eng.submit(long2, MAX_NEW)
            if not gate.reached.wait(timeout=300):
                raise AssertionError(f"{label}: the second long prompt never prefilled")
            marked = eng.cancel_requests(1)
        finally:
            gate.remove()
        try:
            fut.result(timeout=300)
            raise AssertionError(f"{label}: the cancelled long prompt completed")
        except RequestCancelled:
            pass
        if marked != 1 or fut.finish_reason != "cancelled" or len(eng._free) != eng.slots:
            raise AssertionError(f"{label}: cancel marked {marked}, finish "
                                 f"{fut.finish_reason!r}, {len(eng._free)} slots free")
        if eng.paged and eng._alloc.available() != eng._alloc.n_blocks:
            raise AssertionError(f"{label}: the cancelled prompt's blocks were not freed")
        emit(phase=label, card=card, prewarm_s=prewarm_s, requests=len(out), wall_s=wall,
             prompt_tokens=CHUNKED_PROMPT, prefill_chunks=chunks, decode_steps=steps,
             launches=counts, short_ttft_ms_p50_with_long=float(np.median(short_ttft)),
             short_ttft_ms_p50_alone=float(np.median(alone_ttft)),
             long_ttft_ms=long_ttft[0], **held,
             cancelled_after_first_chunk=True, peak_mem_gib=torch.cuda.max_memory_allocated()
             / 2**30)
    finally:
        httpd.close()
        server.close()
        del model, server
        gc.collect()
        torch.cuda.empty_cache()


def serve_chunked_phase(card: str, prompts, short_tokens: dict) -> None:
    """Chunked prefill in the three layouts (``serve_chunked``); the
    observability routes are read on the paged bf16 server. One prewarm
    serves the three: the paged engine's brings the process's caching
    allocator up for these shapes (a prewarm is ~18 s of waves on an H100,
    most of it decode chunks dispatched ahead of each first token), and
    each later engine's worker makes its own cuBLAS handle at its first
    step."""
    for i, (layout, kw) in enumerate((("paged", {}), ("contiguous", dict(paged=False)),
                                      ("int8", dict(kv_dtype="int8")))):
        serve_chunked(card, layout, prompts, short_tokens[layout], prewarm=i == 0, **kw)


# -- phase 5c: BERT-base behind the DynamicBatcher ---------------------------------------

BERT_SEQ = 128  # the JAX serving bench's SEQ
BERT_REQUESTS = 16


def bert_attention_phase(card: str, cfg, params, rows) -> None:
    """BERT-base (the served weights, 8 rows) with ``auto_attention``
    against the same model with ``full_attention``, in bf16 and in f32, at
    L 128 and at a ragged L 100. Each forward launches ``flash_fwd`` once a
    layer, the logits stay within 0.1, and every argmax flip is a near-tie
    of ``full_attention``'s logits (``NEAR_TIE``); in f32 the argmax agrees
    on >= 99% of positions. In bf16 it need not (PERF.md §6, PR 13): each
    layer's attention is run on the ``full_attention`` model's own q, k, v,
    and the kernel's output may differ from ``full_attention``'s in at most
    ``SPLIT_LIMIT`` of its elements (in f32, by at most 1e-4); and the bf16
    model's argmax must agree with the f32 model's at least as often as the
    bf16 ``full_attention`` model's does, less ``BF16_ARGMAX_SLACK``. The
    model whose attention is the kernel's plain version (the same f32
    function, summed in another order) is printed as a control."""
    from kubeflow_tpu_torch.models.bert import BertForMaskedLM
    from kubeflow_tpu_torch.ops import flash_attention as fa
    from kubeflow_tpu_torch.parallel.ring_attention import full_attention

    def plain_attention(q, k, v, **kw):
        return fa.flash_attention_plain(q, k, v, **kw)

    def agreement(x, y):
        return float((x.argmax(-1) == y.argmax(-1)).float().mean())

    ids = torch.as_tensor(rows, device="cuda")
    logits = {}
    for dtype in (torch.float32, torch.bfloat16):
        c = dataclasses.replace(cfg, dtype=dtype)
        seen = []

        def recording(q, k, v, **kw):
            seen.append((q, k, v, kw))
            return full_attention(q, k, v, **kw)

        flash = BertForMaskedLM.bind(c, params, attention_fn=fa.auto_attention)
        full = BertForMaskedLM.bind(c, params, attention_fn=recording)
        plain = BertForMaskedLM.bind(c, params, attention_fn=plain_attention)
        bf16 = dtype == torch.bfloat16
        for L in (BERT_SEQ, 100):
            with torch.no_grad():
                fa.reset_launches()
                a = flash(ids[:, :L])
                n = fa.LAUNCHES["flash_fwd"]
                seen.clear()
                b = full(ids[:, :L])
                p = plain(ids[:, :L])
                # each layer's attention on the full_attention model's inputs
                share, layer_err = [], 0.0
                for q, k, v, kw in seen:
                    ref = full_attention(q, k, v, **kw)
                    got = fa.flash_attention(q, k, v, **kw)
                    share.append(float((got != ref).float().mean()))
                    layer_err = max(layer_err, max_abs_err(got, ref))
            key = f"{'bf16' if bf16 else 'f32'}_l{L}"
            logits[key] = (a, b)
            top2 = torch.topk(b, 2, dim=-1).values
            flips = a.argmax(-1) != b.argmax(-1)
            gaps = (top2[..., 0] - top2[..., 1])[flips]
            err, agree = max_abs_err(a, b), agreement(a, b)
            against_f32 = {}
            if bf16:
                truth = logits[f"f32_l{L}"][1]
                against_f32 = dict(flash_argmax_agreement_with_f32=agreement(a, truth),
                                   full_argmax_agreement_with_f32=agreement(b, truth))
            emit(phase="bert_attention", card=card, case=key, flash_fwd_launches=n,
                 max_abs_err=err, argmax_agreement=agree, argmax_flips=int(flips.sum()),
                 largest_top2_gap_at_a_flip=float(gaps.max()) if len(gaps) else None,
                 median_top2_gap=float((top2[..., 0] - top2[..., 1]).median()),
                 plain_attention_argmax_agreement=agreement(p, b),
                 plain_attention_max_abs_err=max_abs_err(p, b), layer_share_off=share,
                 layer_max_abs_err=layer_err, near_tie_limit=NEAR_TIE,
                 split_limit=SPLIT_LIMIT, **against_f32)
            if n != cfg.num_layers or len(share) != cfg.num_layers or not err <= 0.1:
                raise AssertionError(f"bert_attention {key}: {n} flash_fwd launches over "
                                     f"{len(share)} layers, max err {err}")
            if len(gaps) and float(gaps.max()) >= NEAR_TIE:
                raise AssertionError(f"bert_attention {key}: an argmax flip at a top-2 gap "
                                     f"of {float(gaps.max())} (not a near-tie)")
            if not bf16 and (agree < 0.99 or layer_err > 1e-4):
                raise AssertionError(f"bert_attention {key}: argmax agreement {agree}, "
                                     f"per-layer max err {layer_err}")
            if bf16 and (max(share) > SPLIT_LIMIT or against_f32[
                    "flash_argmax_agreement_with_f32"] < against_f32[
                    "full_argmax_agreement_with_f32"] - BF16_ARGMAX_SLACK):
                raise AssertionError(f"bert_attention {key}: per-layer share off "
                                     f"full_attention {share}; against f32 {against_f32}")


def bert_phase(card: str) -> None:
    """BERT-base (seeded weights, bf16, ``auto_attention``) behind
    ``ModelServer``: 16 concurrent single-instance requests through
    ``ModelServer._predict``, unbatched and then batched
    (``batching=True``; every count reset just before and read just after),
    plus one over HTTP. Each batched answer is within 0.1 of its unbatched
    one with >= 99% argmax agreement; the mean batch is above one row;
    ``flash_fwd`` launched 12 times a forward. Then the model itself
    (``bert_attention_phase``)."""
    from kubeflow_tpu_torch.models.bert import BertConfig
    from kubeflow_tpu_torch.ops import flash_attention as fa
    from kubeflow_tpu_torch.runtime.metrics import METRICS
    from kubeflow_tpu_torch.serving.server import ModelServer, bert_served_model

    cfg = BertConfig.base()
    model = bert_served_model(name="bert", tiny=False, device="cuda", seed=0)
    rows = np.random.default_rng(2).integers(0, cfg.vocab_size, (BERT_REQUESTS, BERT_SEQ)) \
        .astype(np.int32).tolist()

    def drive(server, label):
        out, lat, errors = [None] * len(rows), [None] * len(rows), []

        def one(i):
            try:
                t = time.perf_counter()
                pred = server._predict(model, [rows[i]])
                lat[i] = time.perf_counter() - t
                out[i] = np.asarray(pred[0], np.float32)
            except Exception as e:  # surfaced below, after every thread joined
                errors.append(e)

        threads = [threading.Thread(target=one, args=(i,)) for i in range(len(rows))]
        t0 = time.perf_counter()
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=600)
        wall = time.perf_counter() - t0
        if errors or any(o is None for o in out):
            raise RuntimeError(f"bert_serve {label}: requests failed: {errors}")
        return out, {"requests_per_s": len(rows) / wall, "wall_s": wall,
                     "latency_ms_p50": float(np.percentile(lat, 50)) * 1e3,
                     "latency_ms_p99": float(np.percentile(lat, 99)) * 1e3}

    def close_to(a, b):
        return max_abs_err(torch.as_tensor(a), torch.as_tensor(b)), \
            float((a.argmax(-1) == b.argmax(-1)).mean())

    unbatched = ModelServer().add(model)
    batched = ModelServer(batching=True).add(model)
    httpd = batched.serve(0)
    try:
        model.predict(rows[:1])  # warm-up: cuBLAS handles, allocator
        ref, plain = drive(unbatched, "unbatched")
        batched._predict(model, rows[:1])
        torch.cuda.synchronize()
        fa.reset_launches()
        METRICS.reset()
        got, timing = drive(batched, "batched")
        launches = fa.LAUNCHES["flash_fwd"]
        forwards = int(METRICS.value("serving_batches_total", model="bert"))
        hist = METRICS.histogram("serving_batch_rows", model="bert")
        mean_rows = hist.sum / hist.total if hist.total else 0.0
        if forwards == 0 or launches != cfg.num_layers * forwards:
            raise AssertionError(f"bert_serve: {launches} flash_fwd launches over {forwards} "
                                 f"batched forwards; expected {cfg.num_layers} a forward")
        if mean_rows <= 1.0:
            raise AssertionError(f"bert_serve: mean batch of {mean_rows} rows")
        errs = [close_to(g, r) for g, r in zip(got, ref)]
        err, agree = max(e for e, _ in errs), min(a for _, a in errs)
        if not (err <= 0.1 and agree >= 0.99):
            raise AssertionError(f"bert_serve: batched vs unbatched max err {err}, "
                                 f"argmax agreement {agree}")
        req = urllib.request.Request(
            f"http://127.0.0.1:{httpd.port}/v1/models/bert:predict",
            data=json.dumps({"instances": rows[:1]}).encode(),
            headers={"Content-Type": "application/json"}, method="POST")
        t0 = time.perf_counter()
        with urllib.request.urlopen(req, timeout=600) as resp:
            http_pred = np.asarray(json.loads(resp.read())["predictions"][0], np.float32)
        http_s = time.perf_counter() - t0
        http_err, http_agree = close_to(http_pred, ref[0])
        if http_pred.shape != (BERT_SEQ, cfg.vocab_size) or not (
                http_err <= 0.1 and http_agree >= 0.99):
            raise AssertionError(f"bert_serve: HTTP answer {http_pred.shape}, err {http_err}")
        emit(phase="bert_serve", card=card, seq=BERT_SEQ, requests=len(rows),
             batched=timing, unbatched=plain, batched_forwards=forwards,
             mean_batch_rows=mean_rows, flash_fwd_launches=launches, max_abs_err=err,
             argmax_agreement=agree, http_s=http_s, http_max_abs_err=http_err)

        bert_attention_phase(card, cfg, model.params, rows[:8])
    finally:
        httpd.close()
        batched.close()
        unbatched.close()
        del model
        gc.collect()
        torch.cuda.empty_cache()


# -- phases 5d-5f: speculative decoding, draft distillation, prefill/decode roles ----------

SPEC_K = 4
#: the self-draft's depth: GPT-small's bottom quarter (``draft_config``'s default)
DRAFT_LAYERS = 3
#: the paged writes' wrappers, none of which may launch in a speculative run: the
#: verify forward writes spec_k rows a slot through the multi-row paths
PAGED_WRITES = ("kv_block_update", "kv_block_update_pair", "kv_block_update_quant",
                "kv_block_update_quant_pair")


#: the least accept rate of the target drafting for itself in bf16: every draft
#: matches but where the verify forward's [32, .] GEMMs flip a near-tie of the
#: draft's [8, .] step
TARGET_DRAFT_ACCEPT = 0.8


def expect_spec(label: str, counts: dict, rounds: int, steps: int,
                draft_layers: int = DRAFT_LAYERS) -> None:
    """A speculative run's KV launches: ``kv_row_update_pair`` once per draft
    layer and draft step, no paged write and no plain decode step."""
    want = draft_layers * SPEC_K * rounds
    if (rounds == 0 or steps or counts["kv_row_update_pair"] != want or counts["kv_row_update"]
            or any(counts[n] for n in PAGED_WRITES)):
        raise AssertionError(f"{label}: {counts} over {rounds} spec rounds and {steps} decode "
                             f"steps; expected {want} kv_row_update_pair and no paged write")


def expect_pair(label: str, counts: dict, pair: str, steps: int, n_layers: int) -> None:
    """A paged run's KV launches: ``pair`` once per layer and decode step, and
    no other KV write."""
    if (steps == 0 or counts[pair] != n_layers * steps
            or any(counts[n] for n in PAGED_WRITES if n != pair)
            or counts["kv_row_update_pair"]):
        raise AssertionError(f"{label}: {counts} over {steps} decode steps; expected "
                             f"{n_layers} {pair} a step and no other write")


def self_draft(cfg, params):
    """The ``DRAFT_LAYERS``-layer self-draft: the target's bottom blocks and
    its embeddings (``init_from_target``)."""
    from kubeflow_tpu_torch.training.distill import draft_config, init_from_target

    dcfg = draft_config(cfg, DRAFT_LAYERS)
    return dcfg, init_from_target(dcfg, params)


def spec_serve_phase(card: str, prompts, short_tokens: dict, serve_stats: dict) -> dict:
    """Phase 5d: GPT-small served speculatively (``spec_k`` 4) in the three
    KV layouts with the 3-layer self-draft, then in paged bf16 and
    contiguous with the target as its own draft, the 8 prompts of phases
    3-5 at 32 new tokens: tokens held to each layout's non-speculative
    kernel-path run by ``near_tie`` (the verify forward's bf16 GEMMs have
    other shapes than a one-token step's), the draft's
    ``kv_row_update_pair`` launches, no paged write; the target as draft
    accepts at least ``TARGET_DRAFT_ACCEPT`` of its drafts, so rounds that
    commit several tokens are held to the plain run too; the accept rate,
    rounds, tokens/s and TTFT p50 beside the non-speculative run's.
    Returns the ``kv_row_update_pair`` launches of each run by label."""
    from kubeflow_tpu_torch.models.gpt import GptConfig

    cfg = GptConfig.small()
    launches = {}
    runs = [(layout, kw, self_draft, DRAFT_LAYERS)
            for layout, kw in (("paged", {}), ("contiguous", dict(paged=False)),
                               ("int8", dict(kv_dtype="int8")))]
    runs += [(layout, kw, lambda c, p: (c, p), cfg.n_layers)
             for layout, kw in (("paged", {}), ("contiguous", dict(paged=False)))]
    for layout, kw, draft, draft_layers in runs:
        label = f"spec_serve_{layout}" + ("_target_draft" if draft_layers == cfg.n_layers
                                          else "")
        gen, counts, st = serve(prompts, card, label, draft=draft, **kw)
        expect_spec(label, counts, st["rounds"], st["steps"], draft_layers)
        differ = 0
        if gen != short_tokens[layout]:
            differ = sum(not near_tie(label, cfg, small_params(), p, toks, want, card)["equal"]
                         for p, toks, want in zip(prompts, gen, short_tokens[layout]))
        base = serve_stats[layout]
        accept = st["accepted"] / st["drafted"]
        emit(phase=label, card=card, spec_k=SPEC_K, draft_layers=draft_layers,
             rounds=st["rounds"], drafted=st["drafted"], accepted=st["accepted"],
             accept_rate=accept, mean_accepted_width=1 + accept * (SPEC_K - 1),
             tokens_per_s=st["tokens_per_s"], tokens_per_s_plain=base["tokens_per_s"],
             ttft_ms_p50=st["ttft_ms_p50"], ttft_ms_p50_plain=base["ttft_ms_p50"],
             requests_equal_to_plain=len(prompts) - differ, near_tie_differences=differ,
             kv_row_update_pair=counts["kv_row_update_pair"])
        if draft_layers == cfg.n_layers and accept < TARGET_DRAFT_ACCEPT:
            raise AssertionError(f"{label}: the target as its own draft accepts {accept} of "
                                 f"its drafts, below {TARGET_DRAFT_ACCEPT}")
        launches[label] = counts["kv_row_update_pair"]
    return launches


def spec_write_phase(card: str) -> None:
    """What a speculative round's verify forward costs in KV writes, at
    GPT-small serving shapes (8 slots, ``SPEC_K`` rows a slot at in-range
    cursors, 12 heads x 64, 2048 positions, 16-row blocks), a layer's K and
    V: the multi-row write the verify runs (``kv_block_update_ref``'s
    scatters, int8 after ``quantize_kv``; the contiguous cache's indexed
    store) against ``SPEC_K`` launches of the layout's pair kernel at
    cursors + j, which must leave the same bytes (``torch.equal``). Call ms
    (CUDA events, back-to-back calls) and device ms (every kernel a call
    launches, torch.profiler), a layer and a round (12 layers)."""
    from kubeflow_tpu_torch.ops import kv_cache as kc

    dev = "cuda"
    g = torch.Generator().manual_seed(1)
    S, T, H, D, bt, k, n_layers = 8, 2048, 12, 64, 16, SPEC_K, 12
    mb = T // bt
    N = S * mb + 1
    cur = torch.tensor([n + MAX_NEW // 2 for n in PROMPT_LENS], dtype=torch.int32).to(dev)
    curs = [cur + j for j in range(k)]
    tables = torch.randperm(N - 1, generator=g)[: S * mb].reshape(S, mb).int().to(dev)
    seg = [torch.randn(S, k, H, D, generator=g).to(dev, torch.bfloat16) for _ in range(2)]
    rows = [[x[:, j].contiguous() for j in range(k)] for x in seg]
    blank = {"paged": [torch.zeros(N, bt, H, D, dtype=torch.bfloat16, device=dev)
                       for _ in range(2)],
             "int8": [torch.zeros(N, bt, H, D, dtype=torch.int8, device=dev),
                      torch.zeros(N, bt, H, 1, device=dev)] * 2,
             "contiguous": [torch.zeros(S, T, H, D, dtype=torch.bfloat16, device=dev)
                            for _ in range(2)]}
    slot = torch.arange(S, device=dev)[:, None]
    pos = cur.long()[:, None] + torch.arange(k, device=dev)

    def verify(layout, t):
        if layout == "paged":
            for arena, x in zip(t, seg):
                kc.kv_block_update_ref(arena, x, cur, tables, max_seq=T)
        elif layout == "int8":
            for (arena, scales), x in zip((t[:2], t[2:]), seg):
                q, sc = kc.quantize_kv(x)
                kc.kv_block_update_ref(arena, q, cur, tables, max_seq=T)
                kc.kv_block_update_ref(scales, sc, cur, tables, max_seq=T)
        else:
            for cache, x in zip(t, seg):
                cache[slot, pos] = x

    def pairs(layout, t):
        for j in range(k):
            if layout == "paged":
                kc.kv_block_update_pair(*t, rows[0][j], rows[1][j], curs[j], tables, max_seq=T)
            elif layout == "int8":
                kc.kv_block_update_quant_pair(*t, rows[0][j], rows[1][j], curs[j], tables,
                                              max_seq=T)
            else:
                kc.kv_row_update_pair(*t, rows[0][j], rows[1][j], curs[j])

    for layout, pair in (("paged", "kv_block_update_pair"),
                         ("int8", "kv_block_update_quant_pair"),
                         ("contiguous", "kv_row_update_pair")):
        want = [t.clone() for t in blank[layout]]
        verify(layout, want)
        got = [t.clone() for t in blank[layout]]
        pairs(layout, got)
        torch.cuda.synchronize()
        if not all(torch.equal(a, b) for a, b in zip(got, want)):
            raise AssertionError(f"spec_write {layout}: {k} {pair} launches at cursors + j "
                                 f"differ from the verify forward's write")
        times = {}
        for route, fn in (("verify_write", verify), (f"{pair}_x{k}", pairs)):
            work = [t.clone() for t in blank[layout]]
            call = lambda: fn(layout, work)
            times[route] = dict(call_ms=cuda_ms(call, iters=100),
                                device_ms=library_device_ms(call)[0])
        emit(phase="spec_write", card=card, layout=layout, rows_a_slot=k, slots=S,
             equal_bytes=True, per="layer (K and V)", **{
                 f"{route}_{m}": v for route, d in times.items() for m, v in d.items()},
             **{f"{route}_{m}_a_round": v * n_layers
                for route, d in times.items() for m, v in d.items()})


def distill_phase(card: str) -> dict:
    """Phase 5e: ``distill_draft`` at the JAX defaults (300 steps, batch 8,
    32 sequences of 16 + 48 tokens, lr 1e-3) on a GPT-small teacher, the
    3-layer draft, saved through ``checkpoint_dir``: the flash launches of
    each step (``flash_fwd`` 12 + 3, ``flash_bwd_dq`` and ``flash_bwd_dkv``
    3), the last step's KL below the first's; the checkpoint read back by
    ``Checkpointer.restore_numpy`` (meta ``kind`` "spec_draft", ``steps``
    and ``final_kl`` the run's) and carried into the port by
    ``params_from_flax``, every tensor bit-equal to the returned draft's;
    ``measure_accept_rate`` of the RESTORED draft at least the
    self-draft's; steps/s, the save and restore seconds (the checkpoint
    histograms) and the bytes on disk. Returns the flash kernels'
    launches."""
    from kubeflow_tpu_torch.models.convert import params_from_flax
    from kubeflow_tpu_torch.models.gpt import GptConfig
    from kubeflow_tpu_torch.ops import flash_attention as fa
    from kubeflow_tpu_torch.runtime.metrics import METRICS
    from kubeflow_tpu_torch.training import distill
    from kubeflow_tpu_torch.training.checkpoint import Checkpointer

    cfg = GptConfig.small()
    params = small_params()
    dcfg = distill.draft_config(cfg)
    self_accept = distill.measure_accept_rate(cfg, params, dcfg,
                                              distill.init_from_target(dcfg, params))
    curve, stamps = [], []

    def on_step(step, kl):
        curve.append(kl)
        stamps.append(time.perf_counter())

    with tempfile.TemporaryDirectory(prefix="chip_smoke_draft_") as ckdir:
        save0, restore0 = checkpoint_seconds(METRICS)
        fa.reset_launches()
        t0 = time.perf_counter()
        _, draft = distill.distill_draft(cfg, params, checkpoint_dir=ckdir, on_step=on_step)
        wall = time.perf_counter() - t0
        counts = dict(fa.LAUNCHES)
        ckpt = Checkpointer(ckdir)
        tree, meta = ckpt.restore_numpy()
        restored = params_from_flax(tree, dcfg)
        save1, restore1 = checkpoint_seconds(METRICS)
        disk_bytes = dir_bytes(ckdir)
        step_dirs = ckpt.all_steps()
    steps = len(curve)
    want = {"flash_fwd": (cfg.n_layers + dcfg.n_layers) * steps,
            "flash_bwd_dq": dcfg.n_layers * steps, "flash_bwd_dkv": dcfg.n_layers * steps}
    if counts != want:
        raise AssertionError(f"distill: flash launches {counts} over {steps} steps; "
                             f"expected {want}")
    if not all(np.isfinite(curve)) or not curve[-1] < curve[0]:
        raise AssertionError(f"distill: KL {curve[0]} -> {curve[-1]} did not fall")
    if (step_dirs != [steps] or meta.get("kind") != "spec_draft" or meta.get("steps") != steps
            or meta.get("final_kl") != round(curve[-1], 6)
            or meta.get("draft_layers") != dcfg.n_layers):
        raise AssertionError(f"distill: checkpoint steps {step_dirs}, meta {meta}; the run "
                             f"took {steps} steps to KL {curve[-1]}")
    if sorted(restored) != sorted(draft) or not all(
            torch.equal(restored[k], draft[k].cpu()) for k in draft):
        raise AssertionError("distill: the restored draft differs from the distilled one")
    restored = {k: v.to("cuda") for k, v in restored.items()}
    accept = distill.measure_accept_rate(cfg, params, dcfg, restored)
    emit(phase="distill", card=card, steps=steps, draft_layers=dcfg.n_layers,
         kl_first=curve[0], kl_last=curve[-1], wall_s=wall,
         steps_per_s=(steps - 1) / (stamps[-1] - stamps[0]),
         accept_rate_self_draft=self_accept, accept_rate_distilled_restored=accept,
         checkpoint_meta=meta, checkpoint_save_s=save1 - save0,
         checkpoint_restore_s=restore1 - restore0, checkpoint_disk_bytes=disk_bytes,
         restored_bit_equal=True, flash_launches=counts,
         peak_mem_gib=torch.cuda.max_memory_allocated() / 2**30)
    if accept < self_accept:
        raise AssertionError(f"distill: the restored distilled draft accepts {accept}, below "
                             f"the self-draft's {self_accept}")
    return counts


def checkpoint_seconds(metrics) -> tuple:
    """The ``checkpoint_save_seconds`` and ``checkpoint_restore_seconds``
    histograms' sums: the seconds every save and restore so far took."""
    from kubeflow_tpu_torch.training.checkpoint import SAVE_BUCKETS

    return tuple(metrics.histogram(name, buckets=SAVE_BUCKETS).sum
                 for name in ("checkpoint_save_seconds", "checkpoint_restore_seconds"))


def dir_bytes(path: str) -> int:
    return sum(os.path.getsize(os.path.join(d, f)) for d, _, files in os.walk(path)
               for f in files)


def disagg_phase(card: str, prompts) -> dict:
    """Phase 5f: a prefill-role engine handing off to a decode-role engine
    through ``submit_handoff`` (its sink), GPT-small, paged bf16 and int8,
    each without and with the speculative self-draft: the 8 prompts and a
    1,500-token one (6 chunks on the prefill side) at 32 new tokens, held
    to a unified engine with the same options on the card, exactly. The
    decode side's KV launches: the layout's pair kernel once per layer and
    decode step (``expect_spec``'s counts with the draft). Without the
    draft, first one request alone on the fresh engines: the decode
    engine's arena blocks ``torch.equal`` to the never-moved unified
    engine's. Blob bytes a request, ``serving_kv_handoff_seconds`` p50 and
    p99. Returns the KV kernels' launches on the decode side."""
    from kubeflow_tpu_torch.models.gpt import GptConfig
    from kubeflow_tpu_torch.ops import kv_cache as kc
    from kubeflow_tpu_torch.runtime.metrics import METRICS
    from kubeflow_tpu_torch.serving.continuous import ContinuousBatcher

    cfg = GptConfig.small()
    params = small_params()
    long_p = np.random.default_rng(7).integers(0, cfg.vocab_size, CHUNKED_PROMPT).astype(np.int32)
    jobs = list(prompts) + [long_p]
    spec = dict(spec_draft=self_draft(cfg, params), spec_k=SPEC_K)
    totals: Counter = Counter()

    def run(engine, reqs):
        futs = [engine.submit(p, MAX_NEW) for p in reqs]
        return [f.result(timeout=600) for f in futs], futs

    for name, kw in (("bf16", {}), ("int8", dict(kv_dtype="int8")),
                     ("bf16_spec", spec), ("int8_spec", dict(kv_dtype="int8", **spec))):
        label = f"disagg_{name}"
        pair = "kv_block_update_quant_pair" if "int8" in name else "kv_block_update_pair"
        unified = ContinuousBatcher(cfg, params, engine_id="u", device="cuda", **kw)
        decode = ContinuousBatcher(cfg, params, engine_id="d", role="decode", device="cuda",
                                   **kw)
        prefill = ContinuousBatcher(cfg, params, engine_id="p", role="prefill", device="cuda",
                                    handoff_sink=decode.submit_handoff, **kw)
        try:
            arenas_equal = None
            if "spec_draft" not in kw:
                one = [prompts[3]]
                if run(unified, one)[0] != run(prefill, one)[0]:
                    raise AssertionError(f"{label}: one request's tokens differ from unified")
                torch.cuda.synchronize()
                arenas_equal = all(
                    torch.equal(u["attention"][k][:-1], d["attention"][k][:-1])
                    for u, d in zip(unified.cache.values(), decode.cache.values())
                    for k in u["attention"] if k != "cursors")
                if not arenas_equal:
                    raise AssertionError(f"{label}: imported arena blocks differ from the "
                                         f"never-moved engine's")
            want, _ = run(unified, jobs)
            torch.cuda.synchronize()
            kc.reset_launches()
            METRICS.reset()
            t0 = time.perf_counter()
            got, futs = run(prefill, jobs)
            wall = time.perf_counter() - t0
            counts = dict(kc.LAUNCHES)
            steps = int(METRICS.value("serving_decode_steps_total"))
            rounds = int(METRICS.value("serving_spec_rounds_total"))
            if got != want:
                bad = [len(p) for p, a, b in zip(jobs, got, want) if a != b]
                raise AssertionError(f"{label}: tokens of the {bad}-token prompts differ from "
                                     f"the unified engine's")
            if "spec_draft" in kw:
                expect_spec(label, counts, rounds, steps)
            else:
                expect_pair(label, counts, pair, steps, cfg.n_layers)
            sizes = [len(f.kv_blob) for f in futs]
            if METRICS.value("serving_kv_handoff_total") != len(jobs) \
                    or METRICS.value("serving_kv_import_total") != len(jobs):
                raise AssertionError(f"{label}: not every request was handed off and imported")
            emit(phase=label, card=card, requests=len(jobs), wall_s=wall,
                 tokens_per_s=len(jobs) * MAX_NEW / wall, equal_to_unified=True,
                 arenas_equal_to_never_moved=arenas_equal, decode_steps=steps,
                 spec_rounds=rounds, launches=counts,
                 blob_bytes_short_mean=float(np.mean(sizes[:-1])), blob_bytes_long=sizes[-1],
                 handoff_s_p50=METRICS.quantile("serving_kv_handoff_seconds", 0.5),
                 handoff_s_p99=METRICS.quantile("serving_kv_handoff_seconds", 0.99))
            for k, n in counts.items():
                totals[k] += n
        finally:
            prefill.close()
            decode.close()
            unified.close()
            del prefill, decode, unified
            gc.collect()
            torch.cuda.empty_cache()
    return {k: totals[k] for k in ("kv_row_update_pair", "kv_block_update_pair",
                                   "kv_block_update_quant_pair")}


# -- phase 5g: the serving fleet ------------------------------------------------

#: (a)'s second pass: the first prompts again, routed by prefix
FLEET_SECOND_PASS = 4
#: the fleet phase's autoscaler: scale on TTFT alone, one step up, then hold
FLEET_BURSTS = 4
#: requests a burst (the first prompts, 8 new tokens each)
FLEET_BURST = 4
FLEET_COOLDOWN_TICKS = 3
#: new tokens a request in the pools run (d): its six replicas' worker
#: threads share one interpreter, so a step there costs several of a single
#: engine's; the first 16 tokens are the 32-token run's first 16
FLEET_POOL_NEW = 16


def hold_tokens(label: str, card: str, cfg, params, prompts, got, want) -> int:
    """Each request's tokens against ``want`` (the same prompt on a single
    engine with the same weights and options): equal, or differing first at
    a near-tie of that route (``near_tie``). Returns how many differ."""
    if got == want:
        return 0
    return sum(not near_tie(label, cfg, params, p, toks, w, card)["equal"]
               for p, toks, w in zip(prompts, got, want))


def fleet_phase(card: str, prompts, short_tokens: dict) -> dict:
    """Phase 5g: GPT-small (seeded weights, paged, 8 slots a replica) served by
    ``EngineFleet``s on the one card. (a) ``gpt_served_model(replicas=2)``
    (``max_replicas`` 3) behind ``ModelServer``: the 8 prompts at 32 new
    tokens (each posted once the one before has a slot, so they spread over
    both replicas), then the first ``FLEET_SECOND_PASS`` again at once;
    tokens held to the phase 3 paged run,
    the second pass routed by prefix (one hit a request), ``kv_block_update_pair`` 12
    a decode step and no other KV write, ``/debug/fleet`` naming both
    replicas. (b) Drain: 3 copies of each prompt on a 2-replica fleet
    (prefix affinity puts each prompt's copies on one replica, beyond its 8
    slots), then ``scale_to(1)``: every request completes with phase 3's
    tokens; the requests re-queued and ``fleet_drain_seconds``. (c)
    ``SLOAutoscaler`` on ``RegistryWindowSource``, ``ttft_slo`` a tenth
    of (a)'s TTFT p50, ``breach_ticks`` 2, cooldown 3: bursts of 4
    prompts between ticks scale 1 → 2 once, then hold; the new replica's
    ``fleet_replica_cold_start_seconds``. (d) ``models={"a": seed 0, "b":
    seed 1}``, ``pools={"prefill": 1, "decode": 2}``, ``model_slo={"b":
    "batch"}``, paged bf16 and int8, ``FLEET_POOL_NEW`` tokens: each model's
    tokens held to a single engine's with its weights and options (model a:
    the first tokens of phases 3 and 5),
    ``serving_kv_import_total`` equal to the requests, the decode pool's
    pair kernel 12 a decode step. Tokens/s, TTFT p50, handoff p50/p99,
    drain and cold-start seconds. Returns the KV kernels' launches of (a)
    and (d)."""
    from kubeflow_tpu_torch.models.gpt import GptConfig, init_params
    from kubeflow_tpu_torch.ops import kv_cache as kc
    from kubeflow_tpu_torch.runtime.metrics import METRICS
    from kubeflow_tpu_torch.runtime.tracing import TRACER
    from kubeflow_tpu_torch.serving.autoscaler import (AutoscalerConfig,
                                                       RegistryWindowSource, SLOAutoscaler)
    from kubeflow_tpu_torch.serving.continuous import ContinuousBatcher
    from kubeflow_tpu_torch.serving.fleet import EngineFleet
    from kubeflow_tpu_torch.serving.server import ModelServer, gpt_served_model

    cfg = GptConfig.small()
    totals: Counter = Counter()
    pairs = ("kv_row_update_pair", "kv_block_update_pair", "kv_block_update_quant_pair")

    # (a) two replicas behind the HTTP server, the 8 prompts twice
    model = dataclasses.replace(
        gpt_served_model(name="gpt", tiny=False, max_new_tokens=MAX_NEW, device="cuda",
                         seed=0, replicas=2, params=small_params()), max_replicas=3)
    params = model.params
    server = ModelServer().add(model)
    httpd = server.serve(0)
    try:
        post(httpd.port, np.arange(1, 17, dtype=np.int32))  # warm-up, a prefix of its own
        torch.cuda.synchronize()
        kc.reset_launches()
        METRICS.reset()
        TRACER.reset()
        t0 = time.perf_counter()
        first = generated("fleet_http", prompts,
                          post_all(httpd.port, prompts, "fleet_http", staggered=True),
                          cfg.vocab_size)
        wall1 = time.perf_counter() - t0
        ttft1 = [ms for _, ms in ttft_ms()]
        split = Counter(sp.attributes["replica"]
                        for sp in TRACER.finished_spans("serving.request"))
        hits0 = METRICS.value("fleet_prefix_hits_total")
        t0 = time.perf_counter()
        again = prompts[:FLEET_SECOND_PASS]
        second = generated("fleet_http", again, post_all(httpd.port, again, "fleet_http"),
                           cfg.vocab_size)
        wall2 = time.perf_counter() - t0
        counts = dict(kc.LAUNCHES)
        steps = int(METRICS.value("serving_decode_steps_total"))
        hits = METRICS.value("fleet_prefix_hits_total") - hits0
        snap = get_json(httpd.port, "/debug/fleet")
    finally:
        httpd.close()
        server.close()
        del model, server
        cleanup()
    differ = hold_tokens("fleet_http", card, cfg, params, prompts, first, short_tokens["paged"])
    if second != first[:FLEET_SECOND_PASS]:
        raise AssertionError("fleet_http: the second pass's tokens differ from the first's")
    if hits < FLEET_SECOND_PASS:
        raise AssertionError(f"fleet_http: the second pass made {hits} prefix hits, "
                             f"expected {FLEET_SECOND_PASS}")
    expect_pair("fleet_http", counts, "kv_block_update_pair", steps, cfg.n_layers)
    ids = {r["id"] for r in snap["replicas"]}
    if ids != {"gpt-0", "gpt-1"} or snap["max_replicas"] != 3:
        raise AssertionError(f"fleet_http: /debug/fleet shows {ids}, max {snap['max_replicas']}")
    ttft_p50 = float(np.median(ttft1))
    emit(phase="fleet_http", card=card, replicas=2,
         requests=len(prompts) + FLEET_SECOND_PASS,
         requests_by_replica=dict(split), equal_to_single_engine=len(prompts) - differ,
         near_tie_differences=differ, prefix_hits_second_pass=hits,
         routed=snap["router"]["routed"], wall_s=[wall1, wall2],
         tokens_per_s=len(prompts) * MAX_NEW / wall1,
         tokens_per_s_second_pass=FLEET_SECOND_PASS * MAX_NEW / wall2, ttft_ms_p50=ttft_p50,
         decode_steps=steps, launches=counts)
    for k in pairs:
        totals[k] += counts[k]

    # (b) drain one of two replicas with requests queued on it
    t_b = time.perf_counter()
    fleet = EngineFleet(cfg, params, replicas=2, max_replicas=2, name="drain",
                        register_debug=False, device="cuda")
    try:
        METRICS.reset()
        futs = []
        for i, p in enumerate(prompts):
            futs.append(fleet.submit(p, MAX_NEW))
            # the router reads the slot gauges: let it see this admission
            # before the next request, so the prompts alternate replicas
            deadline = time.monotonic() + 60
            while admitted() < i + 1 and time.monotonic() < deadline:
                time.sleep(0.001)
        futs += [fleet.submit(p, MAX_NEW) for _ in range(2) for p in prompts]
        t0 = time.perf_counter()
        fleet.scale_to(1, reason="chip_smoke")
        scale_s = time.perf_counter() - t0
        got = [f.result(timeout=600) for f in futs]
        drains = fleet.debug_snapshot()["drains"]
    finally:
        fleet.close()
        del fleet
        cleanup()
    if any(f.error is not None for f in futs) or len(drains) != 1:
        raise AssertionError(f"fleet_drain: errors {[f.error for f in futs if f.error]}, "
                             f"drains {drains}")
    differ = hold_tokens("fleet_drain", card, cfg, params, prompts * 3, got,
                         short_tokens["paged"] * 3)
    drain_s = METRICS.histogram("fleet_drain_seconds").sum
    emit(phase="fleet_drain", card=card, requests=len(futs), requeued=drains[0]["requeued"],
         fleet_drain_seconds=drain_s, scale_to_s=scale_s, wall_s=time.perf_counter() - t_b,
         equal_to_single_engine=len(futs) - differ, near_tie_differences=differ)
    if drains[0]["requeued"] < 1:
        raise AssertionError("fleet_drain: the drained replica handed back no request")

    # (c) the SLO autoscaler on the registry's windows
    t_c = time.perf_counter()
    fleet = EngineFleet(cfg, params, replicas=1, max_replicas=3, name="asc",
                        register_debug=False, device="cuda")
    slo = 0.1 * ttft_p50 / 1e3
    asc = SLOAutoscaler(fleet, AutoscalerConfig(
        ttft_slo=slo, queue_wait_slo=1e6, breach_ticks=2, idle_ticks=10**6,
        cooldown_ticks=FLEET_COOLDOWN_TICKS), source=RegistryWindowSource())
    try:
        METRICS.reset()
        # one request first: the window source needs the histograms to exist
        # at the baseline tick
        fleet.submit(prompts[0], 8).result(timeout=600)
        decisions = [asc.tick()]
        windows = []
        for _ in range(FLEET_BURSTS):
            for f in [fleet.submit(p, 8) for p in prompts[:FLEET_BURST]]:
                f.result(timeout=600)
            decisions.append(asc.tick())
            windows.append((asc.last["ttft_p"], asc.last["cooldown"], asc.last["replicas"]))
        cold = METRICS.histogram("fleet_replica_cold_start_seconds")
        cold_s, cold_n = cold.sum, cold.total
    finally:
        fleet.close()
        del fleet
        cleanup()
    if decisions != [None, None, "up", None, None] or windows[-1][2] != 2:
        raise AssertionError(f"fleet_autoscale: decisions {decisions}, windows {windows}")
    emit(phase="fleet_autoscale", card=card, ttft_slo_s=slo, decisions=decisions,
         windows_ttft_p99_cooldown_replicas=windows, cold_start_s=cold_s,
         cold_starts=cold_n, wall_s=time.perf_counter() - t_c)

    # (d) two models over prefill and decode pools, bf16 and int8
    params_b = init_params(cfg, seed=1, device="cuda")
    for dtype, layout, pair in (("bf16", "paged", "kv_block_update_pair"),
                                ("int8", "int8", "kv_block_update_quant_pair")):
        label = f"fleet_pools_{dtype}"
        single = ContinuousBatcher(cfg, params_b, engine_id="b", kv_dtype=dtype, device="cuda")
        try:
            want_b = [f.result(timeout=600) for f in [single.submit(p, FLEET_POOL_NEW)
                                                       for p in prompts]]
        finally:
            single.close()
            del single
        fleet = EngineFleet(models={"a": (cfg, params), "b": (cfg, params_b)},
                            pools={"prefill": 1, "decode": 2}, model_slo={"b": "batch"},
                            max_replicas=2, name="pools", register_debug=False,
                            engine_kwargs={"kv_dtype": dtype}, device="cuda")
        try:
            torch.cuda.synchronize()
            kc.reset_launches()
            METRICS.reset()
            TRACER.reset()
            t0 = time.perf_counter()
            futs = [fleet.submit(p, FLEET_POOL_NEW, model=m)
                    for m in ("a", "b") for p in prompts]
            got = [f.result(timeout=600) for f in futs]
            wall = time.perf_counter() - t0
            counts = dict(kc.LAUNCHES)
            steps = int(METRICS.value("serving_decode_steps_total"))
            imports = METRICS.value("serving_kv_import_total")
            handoff = (METRICS.quantile("serving_kv_handoff_seconds", 0.5),
                       METRICS.quantile("serving_kv_handoff_seconds", 0.99))
            ttft = [ms for _, ms in ttft_ms()]
            roles = Counter(h.role for h in fleet.live_handles())
        finally:
            fleet.close()
            del fleet
            cleanup()
        n = len(prompts)
        want_a = [t[:FLEET_POOL_NEW] for t in short_tokens[layout]]
        differ = (hold_tokens(label, card, cfg, params, prompts, got[:n], want_a)
                  + hold_tokens(label, card, cfg, params_b, prompts, got[n:], want_b))
        if imports != len(futs):
            raise AssertionError(f"{label}: {imports} KV imports for {len(futs)} requests")
        if [f.priority for f in futs] != ["interactive"] * n + ["batch"] * n:
            raise AssertionError(f"{label}: model_slo did not set model b's class")
        expect_pair(label, counts, pair, steps, cfg.n_layers)
        emit(phase=label, card=card, replicas=dict(roles), requests=len(futs),
             equal_to_single_engine=len(futs) - differ, near_tie_differences=differ,
             new_tokens=FLEET_POOL_NEW, wall_s=wall,
             tokens_per_s=len(futs) * FLEET_POOL_NEW / wall,
             ttft_ms_p50=float(np.median(ttft)),
             handoff_s_p50=handoff[0], handoff_s_p99=handoff[1], kv_imports=imports,
             decode_steps=steps, launches=counts)
        for k in pairs:
            totals[k] += counts[k]
    del params_b
    cleanup()
    return {k: totals[k] for k in pairs}


def driver_run(label: str, card: str, run, n_layers: int, forwards: int = 0) -> tuple:
    """One serving driver's run with the KV and flash counts reset just
    before and read just after: it must report ``ok`` (or, for the serving
    driver, its three predictions), launch ``kv_block_update_pair`` once a
    layer a decode step and no other KV write (a GPT driver), or
    ``flash_fwd`` once a layer a forward (``forwards``, the BERT driver).
    Prints the report, the seconds and the counts; returns the counts and
    the report."""
    from kubeflow_tpu_torch.ops import flash_attention as fa
    from kubeflow_tpu_torch.ops import kv_cache as kc
    from kubeflow_tpu_torch.runtime.metrics import METRICS

    torch.cuda.synchronize()
    kc.reset_launches()
    fa.reset_launches()
    METRICS.reset()
    t0 = time.perf_counter()
    report = run()
    seconds = time.perf_counter() - t0
    counts = {**kc.LAUNCHES, **fa.LAUNCHES}
    steps = int(METRICS.value("serving_decode_steps_total"))
    emit(phase=label, card=card, seconds=seconds, decode_steps=steps, launches=counts,
         report=report)
    if forwards:
        if report != {"predictions": 3, "model": "bert"}:
            raise AssertionError(f"{label}: {report}")
        if counts["flash_fwd"] != n_layers * forwards or any(
                counts[k] for k in kc.LAUNCHES):
            raise AssertionError(f"{label}: {counts}; expected {n_layers * forwards} "
                                 "flash_fwd and no KV write")
    else:
        if report.get("ok") is not True:
            raise AssertionError(f"{label}: {report}")
        expect_pair(label, counts, "kv_block_update_pair", steps, n_layers)
    return counts, report


def pod_fleet_run(card: str, prompts, short_tokens: dict) -> dict:
    """23a's Pod-path fleet at GPT-small on the drivers' in-memory cluster;
    returns its KV launches."""
    from kubeflow_tpu_torch.e2e.elastic_cluster import NAMESPACE, PodClient, add_nodes, bind_pending
    from kubeflow_tpu_torch.models.gpt import GptConfig
    from kubeflow_tpu_torch.ops import kv_cache as kc
    from kubeflow_tpu_torch.runtime.metrics import METRICS
    from kubeflow_tpu_torch.serving.errors import FleetSaturated
    from kubeflow_tpu_torch.serving.fleet import EngineFleet

    cfg = GptConfig.small()
    params = small_params()
    two = prompts[:2]
    client = PodClient()
    add_nodes(client, ["gpu-node-0"], 8)
    torch.cuda.synchronize()
    kc.reset_launches()
    METRICS.reset()
    t0 = time.perf_counter()
    fleet = EngineFleet(cfg, params, replicas=2, max_replicas=2, name="pods", client=client,
                        replica_chips=1, poll_interval=0.05, register_debug=False,
                        device="cuda")
    try:
        def serve_on(handle):
            return [f.result(timeout=600)
                    for f in [handle.engine.submit(p, MAX_NEW) for p in two]]

        pods = [h.pod_name for h in fleet.live_handles()]
        if pods != ["pods-0", "pods-1"] or fleet.wait_ready(1, timeout=0.5):
            raise AssertionError(f"pod_fleet: pods {pods} routable before any bind")
        try:
            fleet.submit(two[0], MAX_NEW)
            raise AssertionError("pod_fleet: an unbound fleet took a request")
        except FleetSaturated:
            pass
        for pod in pods:
            if bind_pending(client, pod) != [pod]:
                raise AssertionError(f"pod_fleet: {pod} did not bind")
        if not fleet.wait_ready(2, timeout=30):
            raise AssertionError("pod_fleet: the bound replicas never became routable")
        nodes = [h.node for h in fleet.live_handles()]
        got = [serve_on(h) for h in fleet.live_handles()]
        via_fleet = fleet.submit(two[0], MAX_NEW).result(timeout=600)

        client.delete_opt("v1", "Pod", "pods-0", NAMESPACE)  # a preemption
        deadline = time.monotonic() + 60
        while ([h.pod_name for h in fleet.live_handles()] != ["pods-1", "pods-2"]
               and time.monotonic() < deadline):
            time.sleep(0.01)
        drains = fleet.debug_snapshot()["drains"]
        if ([h.pod_name for h in fleet.live_handles()] != ["pods-1", "pods-2"]
                or [(d["replica"], d["reason"]) for d in drains] != [("pods-0", "preempted")]):
            raise AssertionError(f"pod_fleet: after the delete {fleet.debug_snapshot()}")
        if fleet.wait_ready(2, timeout=0.5):
            raise AssertionError("pod_fleet: the replacement was routable before its bind")
        if bind_pending(client, "pods-2") != ["pods-2"]:
            raise AssertionError("pod_fleet: the replacement did not bind")
        if not fleet.wait_ready(2, timeout=30):
            raise AssertionError("pod_fleet: the replacement never became routable")
        replacement = next(h for h in fleet.live_handles() if h.pod_name == "pods-2")
        got.append(serve_on(replacement))
        counts = dict(kc.LAUNCHES)
        steps = int(METRICS.value("serving_decode_steps_total"))
        cold = METRICS.histogram("fleet_replica_cold_start_seconds")
        cold_n, cold_s = cold.total, cold.sum
    finally:
        fleet.close()
    seconds = time.perf_counter() - t0
    left = [pod for pod in ("pods-0", "pods-1", "pods-2")
            if client.get_opt("v1", "Pod", pod, NAMESPACE) is not None]
    del fleet
    cleanup()
    if got[1] != got[0] or got[2] != got[0] or via_fleet != got[0][0]:
        raise AssertionError("pod_fleet: the replicas' greedy tokens differ")
    differ = hold_tokens("pod_fleet", card, cfg, params, two, got[0],
                         short_tokens["paged"][:2])
    del params
    cleanup()
    if cold_n != 3 or left:
        raise AssertionError(f"pod_fleet: {cold_n} cold starts, pods left {left}")
    expect_pair("pod_fleet", counts, "kv_block_update_pair", steps, cfg.n_layers)
    emit(phase="pod_fleet", card=card, seconds=seconds, nodes=nodes, drains=drains,
         cold_starts=cold_n, cold_start_s=cold_s, equal_to_phase3=len(two) - differ,
         near_tie_differences=differ, decode_steps=steps, launches=counts)
    return counts


def serving_drivers_phase(card: str, prompts, short_tokens: dict) -> dict:
    """Phase 23a: the overload driver and the Pod-path fleet at GPT-small,
    the fleet, observability and serving drivers at JAX's defaults. Returns
    the KV and flash launches of all five runs."""
    from kubeflow_tpu_torch.e2e import (fleet_driver, observability_driver, overload_driver,
                                        serving_driver)
    from kubeflow_tpu_torch.models.bert import BertConfig
    from kubeflow_tpu_torch.models.gpt import GptConfig

    def allocated() -> int:
        # without the cuBLAS workspaces the replicas' threads leave behind
        # (32 MiB each): what is left is tensors
        cleanup()
        torch._C._cuda_clearCublasWorkspaces()
        return torch.cuda.memory_allocated()

    small, tiny = GptConfig.small().n_layers, GptConfig.tiny().n_layers
    totals: Counter = Counter()
    before = allocated()
    totals.update(driver_run("overload_driver", card,
                             lambda: overload_driver.run(device="cuda", tiny=False,
                                                         params=small_params()), small)[0])
    after = allocated()
    emit(phase="overload_driver_memory", card=card, allocated_before=before,
         allocated_after=after)
    # one replica's arena is 144 MiB, the weights ~500 MB
    if after - before > 16 * 2**20:
        raise AssertionError(f"overload_driver: {after - before} bytes still allocated after "
                             "it returned")
    totals.update(pod_fleet_run(card, prompts, short_tokens))
    totals.update(driver_run("fleet_driver", card, lambda: fleet_driver.run(device="cuda"),
                             tiny)[0])
    cleanup()
    totals.update(driver_run("observability_driver", card,
                             lambda: observability_driver.run(device="cuda"), tiny)[0])
    cleanup()
    # the serving driver's three BERT forwards: the direct predict, the
    # three-instance request and the one-instance request
    totals.update(driver_run("serving_driver", card,
                             lambda: serving_driver.run_serving_e2e(device="cuda"),
                             BertConfig.tiny().num_layers, forwards=3)[0])
    cleanup()
    return {k: totals[k] for k in ("kv_block_update_pair", "flash_fwd")}


def monitoring_phase(card: str) -> dict:
    """Phase 24a: the port's monitoring driver at GPT-small
    (``monitoring_driver.run(tiny=False)``: a 2-replica Pod-path fleet whose
    Pods carry ``metrics_url`` and two ops processes, scraped by one
    ``MonitoringPlane``), with the counts reset just before and read just
    after: it must report ``ok`` with three federated targets, the
    ``TtftBurn`` alert fired and then resolved, ONE Warning Event of count
    >= 2, the fleet scaled 2 → 3 by the federated source, and a federated
    TTFT p99; ``kv_block_update_pair`` one a layer a decode step and no
    other KV write. Prints the driver's seconds, the fire and resolve
    ticks, the Event count, the scale-up's cold start and the fast and
    slowed TTFT p50. Returns the KV launches."""
    from kubeflow_tpu_torch.e2e import monitoring_driver
    from kubeflow_tpu_torch.models.gpt import GptConfig

    counts, r = driver_run("monitoring_driver", card, lambda: monitoring_driver.run(
        device="cuda", tiny=False, params=small_params()), GptConfig.small().n_layers)
    if (len(r["federated_targets"]) != 3 or r["event_count"] < 2 or r["autoscaled_to"] != 3
            or r["autoscaler_source"] != "federated" or r["resolved"] is not True
            or r["platform_ttft_p99"] is None or not r["fire_tick"] < r["resolve_tick"]):
        raise AssertionError(f"monitoring_driver: {r}")
    emit(phase="monitoring", card=card, seconds=r["seconds"], fire_tick=r["fire_tick"],
         resolve_tick=r["resolve_tick"], fired_after_s=r["fired_after_s"],
         resolved_after_s=r["resolved_after_s"], event_count=r["event_count"],
         scale_up_cold_start_s=r["scale_up_cold_start_s"],
         ttft_fast_p50_s=r["ttft_fast_p50_s"], ttft_slow_p50_s=r["ttft_slow_p50_s"],
         ttft_threshold_s=monitoring_driver.TTFT_THRESHOLD_S,
         step_delay_s=monitoring_driver.STEP_DELAY_S)
    return {"kv_block_update_pair": counts["kv_block_update_pair"]}


def ref_phase(card: str) -> None:
    """Tiny f32 model: prefill logits and greedy tokens on the card against
    the same weights on the CPU (f32 products, TF32 off on both)."""
    from kubeflow_tpu_torch.models.gpt import (GptConfig, GptLM, _fresh_cache,
                                               generate, init_params)

    torch.backends.cuda.matmul.allow_tf32 = False
    cfg = GptConfig(vocab_size=512, d_model=64, n_layers=2, n_heads=4, d_ff=128,
                    max_seq=128, dtype=torch.float32)
    params = init_params(cfg, seed=1, device="cpu")
    ids = np.random.default_rng(3).integers(0, cfg.vocab_size, (2, 20)).astype(np.int32)
    with torch.no_grad():
        lc = GptLM.bind(cfg, params, decode=True)(torch.as_tensor(ids),
                                                  _fresh_cache(cfg, 2, "cpu"))
        gp = {k: v.cuda() for k, v in params.items()}
        lg = GptLM.bind(cfg, gp, decode=True)(torch.as_tensor(ids).cuda(),
                                              _fresh_cache(cfg, 2, "cuda")).cpu()
    if not torch.isfinite(lg).all():
        raise AssertionError("non-finite logits on the card")
    err = max_abs_err(lg, lc)
    if err > 1e-4:  # f32 sums in another order: ~1e-6 expected
        raise AssertionError(f"card vs CPU logits differ by {err}")
    tc = generate(cfg, params, ids, 24, device="cpu")
    tg = generate(cfg, params, ids, 24, device="cuda").cpu()
    if not torch.equal(tc, tg):
        raise AssertionError("greedy tokens on the card differ from the CPU's")
    emit(phase="ref", card=card, logits_max_abs_err=err, greedy_tokens_equal=True)


def profile_phase(card: str) -> None:
    """Where a decode step's time goes: GPT-small, 8 slots at position 300,
    KV writes through the kernels, greedy argmax — the engine's per-token
    step without the engine — in the paged bf16 arena, then in the
    contiguous cache. Per layout: host ms per step over 32 steps; device
    kernel time (torch.profiler, CUPTI) over 8 more, as a share of their
    wall time (after a warm-up cycle of 8), and the top kernels by device
    time; the KV writes' launches, device ms and host ms (timed around the
    pair calls over 32 more steps) per step."""
    from kubeflow_tpu_torch.models.gpt import GptConfig

    cfg = GptConfig.small()
    params = small_params()
    for paged, pair in ((True, "kv_block_update_pair"), (False, "kv_row_update_pair")):
        profile_layout(card, cfg, params, paged, pair)
    del params
    gc.collect()
    torch.cuda.empty_cache()


def profile_layout(card: str, cfg, params, paged: bool, pair_name: str) -> None:
    from kubeflow_tpu_torch.models.gpt import GptLM
    from kubeflow_tpu_torch.ops import kv_cache as kc

    S, bt = 8, 16
    mb = cfg.max_seq // bt
    model = GptLM.bind(cfg, params, decode=True, per_slot=True, kv_kernel=True, paged=paged)
    kv = (S * mb + 1, bt) if paged else (S, cfg.max_seq)
    names = ("k_arena", "v_arena") if paged else ("k", "v")
    cache = {f"block_{i}": {"attention": {
        **{n: torch.zeros(kv + (cfg.n_heads, cfg.head_dim), dtype=cfg.dtype, device="cuda")
           for n in names},
        "cursors": torch.full((S,), 300, dtype=torch.int32, device="cuda")}}
        for i in range(cfg.n_layers)}
    tables = torch.arange(S * mb, dtype=torch.int32, device="cuda").view(S, mb) if paged \
        else None
    tok = torch.zeros((S,), dtype=torch.int32, device="cuda")

    def steps(n):
        nonlocal tok
        for _ in range(n):
            logits = model(tok[:, None], cache, block_tables=tables)
            tok = torch.argmax(logits[:, -1], dim=-1).to(torch.int32)
        torch.cuda.synchronize()

    pair = getattr(kc, pair_name)
    kv_host_ns = 0

    def timed_pair(*args, **kw):
        nonlocal kv_host_ns
        t = time.perf_counter_ns()
        out = pair(*args, **kw)
        kv_host_ns += time.perf_counter_ns() - t
        return out

    with torch.no_grad():
        steps(3)
        kc.reset_launches()
        t0 = time.perf_counter()
        steps(32)
        step_ms = (time.perf_counter() - t0) / 32 * 1e3
        kv_launches = {k: n / 32 for k, n in kc.LAUNCHES.items() if n}
        prof, window_ms = whole_profile(lambda: steps(8), ("cpu", "cuda"), 1)
        setattr(kc, pair_name, timed_pair)  # the model looks it up at every call
        try:
            steps(32)
        finally:
            setattr(kc, pair_name, pair)
    layout = "paged" if paged else "contiguous"
    if kv_launches != {pair_name: cfg.n_layers}:
        raise AssertionError(f"profile ({layout}): KV launches a step {kv_launches}, "
                             f"expected {cfg.n_layers} {pair_name}")
    by_name = device_ms_by_kernel(prof)
    device_ms = sum(by_name.values())
    kv_device_ms = sum(ms for n, ms in by_name.items() if pair_name in n)
    top = sorted(by_name.items(), key=lambda kv: -kv[1])[:8]
    emit(phase="profile", card=card, layout=layout, step_ms=step_ms,
         tokens_per_s=S * 1e3 / step_ms,
         device_ms_per_step=device_ms / 8 if device_ms else None,
         device_busy_share=device_ms / window_ms if device_ms else None,
         kv_launches_per_step=kv_launches, kv_device_ms_per_step=kv_device_ms / 8,
         kv_host_ms_per_step=kv_host_ns / 32 / 1e6,
         top_kernels_ms_per_step=[[n[:90], ms / 8] for n, ms in top])
    del model, cache


#: the probe's repeats, cut from its defaults (200, 10,000, 5) to pay for
#: phases 19b-19c: calls a time in ``isolated``, calls a part in
#: ``host_split``, timed chunks a row in ``in_model``
KV_PROBE_ITERS, KV_PROBE_HOST_CALLS, KV_PROBE_CHUNKS = 100, 4_000, 1


def kv_probe_phase(card: str) -> None:
    """The KV-write probe (``e2e/kv_update_probe.py``): the writes alone,
    the host split of a write's call, and the decode chunk per token with
    the writes plain and through the kernels."""
    from kubeflow_tpu_torch.e2e import kv_update_probe as probe

    iso = probe.isolated(iters=KV_PROBE_ITERS)
    emit(phase="kv_probe", card=card, isolated_ms=iso)
    emit(phase="kv_probe", card=card,
         host_split_us=probe.host_split(n=KV_PROBE_HOST_CALLS))
    model = probe.in_model(chunks=KV_PROBE_CHUNKS)
    emit(phase="kv_probe", card=card, in_model=model)
    if not all(np.isfinite(list(iso.values()) + list(model.values()))):
        raise AssertionError("kv_probe: a time is not finite")
    gc.collect()
    torch.cuda.empty_cache()


# -- phase 8: flash attention ----------------------------------------------------

FLASH_SOURCE = "kubeflow_tpu_torch/ops/csrc/flash_attention.cu"
FLASH_REPLACES = {
    "flash_fwd": "kubeflow_tpu/ops/flash_attention.py:111 (_fwd_kernel, pallas_call :195)",
    "flash_bwd_dq": "kubeflow_tpu/ops/flash_attention.py:229 (_bwd_dq_kernel, pallas_call :358)",
    "flash_bwd_dkv": "kubeflow_tpu/ops/flash_attention.py:278 (_bwd_dkv_kernel, pallas_call :376)",
}


def flash_bounds(b, h, lq, lk, d, causal, q_offset, k_offset, elt):
    """Least time (ms) of each kernel's work on these inputs, and what bounds
    it: the dots over the visible (query, key) pairs at the bf16 rate, or
    each input read once and each output written once at the HBM rate."""
    q_pos = q_offset + np.arange(lq)
    if causal:
        pairs = int(np.clip(q_pos - k_offset + 1, 0, lk).sum())
    else:
        pairs = lq * lk
    dot = 2.0 * d * pairs * b * h
    qb, kb, rows = b * lq * h * d * elt, b * lk * h * d * elt, b * h * lq * 4
    work = {"flash_fwd": (2 * dot, 2 * qb + 2 * kb + rows),          # q k v -> out lse
            "flash_bwd_dq": (3 * dot, 3 * qb + 2 * kb + 2 * rows),   # q k v do lse delta -> dq
            "flash_bwd_dkv": (4 * dot, 2 * qb + 4 * kb + 2 * rows),  # ... -> dk dv
            # S, dP, dS K, dS^T Q, P^T dO once each; q k v out do lse -> dq dk dv
            "flash_bwd_whole": (5 * dot, 4 * qb + 4 * kb + rows)}
    out = {}
    for name, (flops, nbytes) in work.items():
        t_ops, t_bytes = flops / BF16_FLOPS_PER_S * 1e3, nbytes / HBM_BYTES_PER_S * 1e3
        out[name] = dict(bound_ms=max(t_ops, t_bytes),
                         bound_by="operations" if t_ops >= t_bytes else "bytes",
                         flops=flops, bytes=nbytes)
    return out


def flash_case(fa, label, b, h, lq, lk, d, dtype, atol, lse_atol, causal=True,
               q_offset=0, k_offset=0, bf16_dots=False, seed=0):
    """Each kernel against its plain version on the card, and against itself
    (a second run, bit for bit). Returns the inputs and errors."""
    g = torch.Generator().manual_seed(seed)
    q, k, v = (torch.randn(b, n, h, d, generator=g).to("cuda", dtype) for n in (lq, lk, lk))
    do = torch.randn(b, lq, h, d, generator=g).to("cuda", dtype)
    kw = dict(causal=causal, scale=d ** -0.5, q_offset=q_offset, k_offset=k_offset,
              bf16_dots=bf16_dots)
    runs = []
    for _ in range(2):
        out, lse = fa.flash_attention_fwd(q, k, v, **kw)
        runs.append((out, lse, *fa.flash_attention_bwd(q, k, v, out, lse, do, **kw)))
    torch.cuda.synchronize()
    names = ("out", "lse", "dq", "dk", "dv")
    for name, a, c in zip(names, *runs):
        if not torch.equal(a, c):
            raise AssertionError(f"flash {label}: {name} differs between two runs")
    out, lse, dq, dk, dv = runs[0]
    p_out, p_lse = fa.flash_attention_fwd_plain(q, k, v, **kw)
    plain = (p_out, p_lse, *fa.flash_attention_bwd_plain(q, k, v, out, lse, do, **kw))
    for name, a, c in zip(names, runs[0], plain):
        if a.shape != c.shape or a.dtype != c.dtype:
            raise AssertionError(f"flash {label}: {name} {tuple(a.shape)} {a.dtype}, plain "
                                 f"{tuple(c.shape)} {c.dtype}")
    errs = {n: max_abs_err(a, c) for n, a, c in zip(names, runs[0], plain)}
    limits = {n: (lse_atol if n == "lse" else atol) for n in names}
    bad = {n: e for n, e in errs.items() if not e <= limits[n]}
    if bad or not all(torch.isfinite(t.float()).all() for t in runs[0]):
        raise AssertionError(f"flash {label}: kernel vs plain {errs} (limits {limits})")
    if k_offset >= q_offset + lq:  # no query sees any key
        if out.abs().max() != 0 or dq.abs().max() != 0 or not (lse == fa.NEG_BIG).all():
            raise AssertionError(f"flash {label}: fully masked rows must give out 0, dq 0 "
                                 "and lse -1e30")
    emit(phase="flash", case=label, shape=[b, lq, lk, h, d], dtype=str(dtype),
         causal=causal, q_offset=q_offset, k_offset=k_offset, bf16_dots=bf16_dots,
         max_abs_err=errs, limits=limits, max_abs={n: float(t.float().abs().max())
                                                   for n, t in zip(names, runs[0])},
         deterministic=True)
    return (q, k, v, do, kw), errs


def flash_out_f32_case(fa, label, b, h, lq, lk, d, bf16_dots=False, seed=0) -> dict:
    """The forward's f32 ``out`` on bf16 inputs (the accumulator, not
    rounded): rounded to bf16 it must be the bf16 out bit for bit, lse the
    same, and it must not be the bf16 out widened; against the plain
    version's f32 out on the same inputs within 1e-4 (2e-2 under
    ``bf16_dots``, where p is rounded to bf16 before a sum in another
    order)."""
    g = torch.Generator().manual_seed(seed)
    q, k, v = (torch.randn(b, n, h, d, generator=g).to("cuda", torch.bfloat16)
               for n in (lq, lk, lk))
    kw = dict(causal=True, scale=d ** -0.5, bf16_dots=bf16_dots)
    out, lse = fa.flash_attention_fwd(q, k, v, **kw)
    out32, lse32 = fa.flash_attention_fwd(q, k, v, out_dtype=torch.float32, **kw)
    p_out, _ = fa.flash_attention_fwd_plain(q, k, v, out_dtype=torch.float32, **kw)
    torch.cuda.synchronize()
    rounded_equal = bool(torch.equal(out32.to(torch.bfloat16), out) and torch.equal(lse32, lse))
    widened = bool(torch.equal(out32, out.float()))
    err, limit = max_abs_err(out32, p_out), (2e-2 if bf16_dots else 1e-4)
    emit(phase="flash", case=label, shape=[b, lq, lk, h, d], out_dtype="float32",
         bf16_dots=bf16_dots, rounded_equal_to_bf16_out=rounded_equal,
         equal_to_widened_bf16_out=widened, max_abs_err_vs_plain_f32=err, limit=limit)
    if out32.dtype != torch.float32 or not rounded_equal or widened or not err <= limit:
        raise AssertionError(f"flash {label}: f32 out {out32.dtype}, rounded equal "
                             f"{rounded_equal}, widened {widened}, vs plain {err} ({limit})")
    return {"max_abs_err": err}


def flash_d16_times(fa, card: str) -> None:
    """Call ms (CUDA events) of the three kernels at head_dim 16 (b 8, h 16,
    L 1024, bf16, causal: the tensor-core kernels) beside their bounds and
    the plain versions."""
    b, h, L, d = 8, 16, 1024, 16
    g = torch.Generator().manual_seed(2)
    q, k, v, do = (torch.randn(b, L, h, d, generator=g).to("cuda", torch.bfloat16)
                   for _ in range(4))
    kw = dict(causal=True, scale=d ** -0.5, q_offset=0, k_offset=0, bf16_dots=False)
    out, lse = fa.flash_attention_fwd(q, k, v, **kw)
    bwd_in = (q, k, v, do, lse, fa._delta(out, do))
    bounds = flash_bounds(b, h, L, L, d, True, 0, 0, 2)
    rows = {}
    for name, call in (("flash_fwd", lambda: fa.flash_attention_fwd(q, k, v, **kw)),
                       ("flash_bwd_dq", lambda: fa.bwd_dq_kernel(*bwd_in, **kw)),
                       ("flash_bwd_dkv", lambda: fa.bwd_dkv_kernel(*bwd_in, **kw))):
        ms = cuda_ms(call, iters=20, warmup=3)
        rows[name] = dict(ms=ms, bound_ms=bounds[name]["bound_ms"],
                          bound_by=bounds[name]["bound_by"],
                          achieved_tflops=bounds[name]["flops"] / ms / 1e9)
    rows["plain_fwd_ms"] = cuda_ms(lambda: fa.flash_attention_fwd_plain(q, k, v, **kw),
                                   iters=5, warmup=1)
    rows["plain_bwd_ms"] = cuda_ms(lambda: fa.flash_attention_bwd_plain(
        q, k, v, out, lse, do, **kw), iters=5, warmup=1)
    emit(phase="flash", case="times_d16", card=card, shape=[b, L, L, h, d], dtype="bf16",
         causal=True, **rows)


# share of out, dk and dv elements that may differ from the f32 answer rounded
# to bf16, where p and ds enter their dots as hi + lo (ties at a rounding edge)
SPLIT_LIMIT = 0.02


def flash_split_case(fa, d, b=2, h=4, L=1024, seed=1):
    """The tensor-core kernels' numeric contract on the card: with bf16_dots
    off, p and ds enter their dots as hi + lo, so out, dq, dk and dv are the
    f32 plain answer on the same bf16 values, rounded to bf16, in all but at
    most SPLIT_LIMIT of their elements. hi alone (the bf16_dots kernels) moves
    far more of them past a rounding edge, which shows the check can fail."""
    g = torch.Generator().manual_seed(seed)
    q, k, v, do = (torch.randn(b, L, h, d, generator=g).to("cuda", torch.bfloat16)
                   for _ in range(4))
    qf, kf, vf, dof = (t.float() for t in (q, k, v, do))
    kw = dict(causal=True, scale=d ** -0.5, q_offset=0, k_offset=0)
    ref_out, _ = fa.flash_attention_fwd_plain(qf, kf, vf, **kw)
    share = {}
    for dots in (False, True):
        out, lse = fa.flash_attention_fwd(q, k, v, bf16_dots=dots, **kw)
        delta = fa._delta(out, do)
        dq = fa.bwd_dq_kernel(q, k, v, do, lse, delta, bf16_dots=dots, **kw)
        dk, dv = fa.bwd_dkv_kernel(q, k, v, do, lse, delta, bf16_dots=dots, **kw)
        # the backward's f32 answer from the kernel's own out and lse, so that
        # delta = rowsum(dout * out) is the same in both
        ref_dq, ref_dk, ref_dv = fa.flash_attention_bwd_plain(qf, kf, vf, out.float(), lse, dof,
                                                              **kw)
        share["hi" if dots else "hi+lo"] = {
            n: float((x != r.to(torch.bfloat16)).float().mean())
            for n, x, r in (("out", out, ref_out), ("dq", dq, ref_dq), ("dk", dk, ref_dk),
                            ("dv", dv, ref_dv))}
    emit(phase="flash", case=f"split_d{d}", shape=[b, L, L, h, d],
         share_off_bf16_of_f32=share, limit=SPLIT_LIMIT)
    if not max(share["hi+lo"].values()) <= SPLIT_LIMIT:
        raise AssertionError(f"flash split_d{d}: hi + lo off the f32 answer: {share}")
    if not min(share["hi"].values()) > SPLIT_LIMIT:
        raise AssertionError(f"flash split_d{d}: hi alone passes the split check: {share}")


def flash_phase(card: str):
    """The flash-attention kernels: correctness over the cases the issue
    names, then times at the training path's shapes."""
    import torch.nn.functional as F

    from kubeflow_tpu_torch.ops import flash_attention as fa

    torch.backends.cuda.matmul.allow_tf32 = False
    b, h, L, d = 8, 16, 1024, 64
    (q, k, v, do, kw), errs = flash_case(fa, "main_bf16", b, h, L, L, d, torch.bfloat16,
                                         2e-2, 1e-3)
    for dd in (32, 64):
        flash_case(fa, f"f32_d{dd}", 2, 2, 256, 256, dd, torch.float32, 1e-4, 1e-4)
    flash_case(fa, "non_causal", 2, 2, 256, 256, 64, torch.float32, 1e-4, 1e-4, causal=False)
    flash_case(fa, "lq_ne_lk", 2, 2, 192, 320, 64, torch.float32, 1e-4, 1e-4)
    flash_case(fa, "ragged_d128", 1, 3, 100, 130, 128, torch.float32, 1e-4, 1e-4)
    flash_case(fa, "q_offset_lk", 2, 2, 256, 256, 64, torch.float32, 1e-4, 1e-4, q_offset=256)
    flash_case(fa, "k_offset_10lk", 2, 2, 256, 256, 64, torch.float32, 1e-4, 1e-4,
               k_offset=2560)
    # the same edges in bf16, through the tensor-core forward and dk/dv
    bf = dict(dtype=torch.bfloat16, atol=2e-2, lse_atol=1e-3)
    for dd in (32, 128):
        flash_case(fa, f"bf16_d{dd}", 2, 2, 256, 256, dd, **bf)
    flash_case(fa, "bf16_non_causal", 2, 2, 256, 256, 64, causal=False, **bf)
    flash_case(fa, "bf16_lq_ne_lk", 2, 2, 192, 320, 64, **bf)
    flash_case(fa, "bf16_ragged_d128", 1, 3, 100, 130, 128, **bf)
    flash_case(fa, "bf16_q_offset_lk", 2, 2, 256, 256, 64, q_offset=256, **bf)
    flash_case(fa, "bf16_k_offset_10lk", 2, 2, 256, 256, 64, k_offset=2560, **bf)
    # BERT-base's served attention: non-causal, 12 heads of 64, a batch of
    # 16 rows at L 128 and 8 rows at a ragged L 100
    flash_case(fa, "bert_bf16", 16, 12, 128, 128, 64, causal=False, **bf)
    flash_case(fa, "bert_bf16_l100", 8, 12, 100, 100, 64, causal=False, **bf)
    flash_case(fa, "bf16_dots", 2, 2, 256, 256, 64, torch.float32, 2e-2, 1e-3, bf16_dots=True)
    flash_case(fa, "bf16_dots_bf16", 2, 4, 512, 512, 64, torch.bfloat16, 2e-2, 1e-3,
               bf16_dots=True)
    # head_dim 16 (BERT-tiny's, GPT-tiny's): the SIMT kernels in f32 and the
    # tensor-core kernels in bf16 over the same edges; d 8 and d 80 through
    # the padding to 16 and 128; d 160 refused
    f32 = dict(dtype=torch.float32, atol=1e-4, lse_atol=1e-4)
    for tag, tol in (("f32", f32), ("bf16", bf)):
        flash_case(fa, f"{tag}_d16", 2, 4, 256, 256, 16, **tol)
        flash_case(fa, f"{tag}_d16_non_causal", 2, 4, 256, 256, 16, causal=False, **tol)
        flash_case(fa, f"{tag}_d16_ragged", 1, 3, 100, 130, 16, **tol)
        flash_case(fa, f"{tag}_d16_q_offset_lk", 2, 2, 256, 256, 16, q_offset=256, **tol)
        flash_case(fa, f"{tag}_d16_k_offset_10lk", 2, 2, 256, 256, 16, k_offset=2560, **tol)
        flash_case(fa, f"{tag}_d8_padded", 1, 3, 100, 130, 8, q_offset=30, **tol)
        flash_case(fa, f"{tag}_d80_padded", 1, 3, 100, 130, 80, q_offset=30, **tol)
    flash_case(fa, "bf16_dots_d16", 2, 4, 256, 256, 16, torch.bfloat16, 2e-2, 1e-3,
               bf16_dots=True)
    wide = torch.zeros(1, 64, 1, 160, device="cuda")
    try:
        fa.flash_attention_fwd(wide, wide, wide, causal=True, scale=1.0)
    except ValueError as e:
        emit(phase="flash", case="d160_refused", error=str(e))
    else:
        raise AssertionError("flash: head_dim 160 was not refused")
    for dd, dots in ((16, False), (64, False), (64, True), (80, False)):
        flash_out_f32_case(fa, f"out_f32_d{dd}{'_bf16_dots' if dots else ''}", 2, 4, 300,
                           300, dd, bf16_dots=dots)
    flash_d16_times(fa, card)

    # times at the main path's shapes
    out, lse = fa.flash_attention_fwd(q, k, v, **kw)
    delta = fa._delta(out, do)
    bwd_in = (q, k, v, do, lse, delta)
    # the bf16 calls must reach the tensor-core kernels: each profiler match
    # names the mma kernel, and a SIMT launch would leave its window short
    calls = {
        "flash_fwd": (lambda: fa.flash_attention_fwd(q, k, v, **kw), "flash_fwd_kernel_mma"),
        "flash_bwd_dq": (lambda: fa.bwd_dq_kernel(*bwd_in, **kw), "flash_bwd_dq_kernel_mma"),
        "flash_bwd_dkv": (lambda: fa.bwd_dkv_kernel(*bwd_in, **kw), "flash_bwd_dkv_kernel_mma"),
    }
    plain_fwd = cuda_ms(lambda: fa.flash_attention_fwd_plain(q, k, v, **kw), iters=10, warmup=2)
    plain_bwd = cuda_ms(lambda: fa.flash_attention_bwd_plain(q, k, v, out, lse, do, **kw),
                        iters=10, warmup=2)
    qt, kt, vt = (x.transpose(1, 2).detach().requires_grad_(True) for x in (q, k, v))
    dot = do.transpose(1, 2)
    sdpa = lambda: F.scaled_dot_product_attention(qt, kt, vt, is_causal=True)  # noqa: E731
    lib_fwd = cuda_ms(sdpa, iters=50)

    def sdpa_fwd_bwd():
        torch.autograd.grad(sdpa(), (qt, kt, vt), dot)

    lib_bwd = cuda_ms(sdpa_fwd_bwd, iters=50) - lib_fwd
    # the same yardsticks as device time, by the kernels' own profiler method:
    # the forward, and the backward alone (one forward outside the window)
    lib_fwd_dev, lib_fwd_names = library_device_ms(sdpa)
    sdpa_out = sdpa()
    lib_bwd_dev, lib_bwd_names = library_device_ms(
        lambda: torch.autograd.grad(sdpa_out, (qt, kt, vt), dot, retain_graph=True))
    bounds = flash_bounds(b, h, L, L, d, True, 0, 0, 2)
    results = {}
    for name, (call, match) in calls.items():
        ms = cuda_ms(call, iters=20, warmup=3)
        dev_ms = kernel_device_ms(call, match, iters=10)
        fwd = name == "flash_fwd"
        plain_ms = plain_fwd if fwd else plain_bwd
        library_ms = lib_fwd if fwd else lib_bwd
        lib_dev = lib_fwd_dev if fwd else lib_bwd_dev
        bd = bounds[name]
        err = errs["out"] if fwd else (
            errs["dq"] if name == "flash_bwd_dq" else max(errs["dk"], errs["dv"]))
        results[name] = dict(name=name, route="cuda", source=FLASH_SOURCE,
                             replaces=FLASH_REPLACES[name], max_abs_err=err, ms=ms,
                             plain_ms=plain_ms, bound_ms=bd["bound_ms"],
                             bound_by=bd["bound_by"], library_ms=library_ms)
        emit(phase="flash", kernel=name, card=card, match=match, kernel_ms=ms,
             kernel_device_ms=dev_ms, plain_ms=plain_ms, library_ms=library_ms,
             library_device_ms=lib_dev,
             library_kernels=lib_fwd_names if fwd else lib_bwd_names,
             bound_ms=bd["bound_ms"], bound_by=bd["bound_by"], flops=bd["flops"],
             bytes=bd["bytes"], achieved_tflops=bd["flops"] / dev_ms / 1e9,
             device_ms_over_library=dev_ms / lib_dev,
             library="sdpa forward" if fwd else
             "sdpa backward alone (dq, dk and dv together); library_ms: fwd+bwd minus fwd",
             plain="plain forward" if fwd else "plain backward (dq, dk and dv together)")

    # the forward with an f32 out (ring attention's blocks) beside its bf16 out
    emit(phase="flash", case="out_f32_times", card=card, shape=[b, L, L, h, d],
         bf16_out_ms=cuda_ms(lambda: fa.flash_attention_fwd(q, k, v, **kw), iters=20,
                             warmup=3),
         f32_out_ms=cuda_ms(lambda: fa.flash_attention_fwd(q, k, v, out_dtype=torch.float32,
                                                           **kw), iters=20, warmup=3))

    # the port's whole backward (delta's kernels, dq, dk/dv) against SDPA's
    whole_ms, whole_names = library_device_ms(
        lambda: fa.flash_attention_bwd(q, k, v, out, lse, do, **kw))
    dq_names = [n for n in whole_names if "flash_bwd_dq_kernel" in n]
    if not dq_names or not all("flash_bwd_dq_kernel_mma" in n for n in dq_names):
        raise AssertionError(f"flash: the bf16 backward launched {dq_names}, "
                             "not the tensor-core dq kernel")
    bd = bounds["flash_bwd_whole"]
    emit(phase="flash", kernel="flash_bwd_whole", card=card, device_ms=whole_ms,
         kernels=whole_names, library_device_ms=lib_bwd_dev, library_kernels=lib_bwd_names,
         device_ms_over_library=whole_ms / lib_bwd_dev, bound_ms=bd["bound_ms"],
         bound_by=bd["bound_by"], flops=bd["flops"], bytes=bd["bytes"],
         achieved_tflops=bd["flops"] / whole_ms / 1e9,
         library_achieved_tflops=bd["flops"] / lib_bwd_dev / 1e9)
    del q, k, v, do, out, lse, delta, qt, kt, vt, sdpa_out
    gc.collect()
    torch.cuda.empty_cache()
    # after the times: in a run with these before them, the profiler's
    # windows lost every flash_fwd launch (torch 2.11, CUDA 12.8, H100)
    for dd in (16, 32, 64, 128):
        flash_split_case(fa, dd)
    return results


# -- phases 9-11: GPT training -------------------------------------------------------

def train_ref_phase(card: str) -> None:
    """A tiny f32 GPT (head_dim 64, a ragged L of 100): loss and every
    gradient through the kernels on the card against the plain path on the
    CPU, from the same weights (f32 products, TF32 off on both)."""
    from kubeflow_tpu_torch.models.gpt import GptConfig, GptLM, init_params
    from kubeflow_tpu_torch.ops import flash_attention as fa
    from kubeflow_tpu_torch.training.gpt import loss_fn

    torch.backends.cuda.matmul.allow_tf32 = False
    cfg = GptConfig(vocab_size=512, d_model=128, n_layers=2, n_heads=2, d_ff=256,
                    max_seq=128, dtype=torch.float32)
    params = init_params(cfg, seed=2, device="cpu")
    ids = torch.as_tensor(np.random.default_rng(4).integers(0, cfg.vocab_size, (2, 100)))
    grads, losses = [], []
    fa.reset_launches()
    for dev in ("cpu", "cuda"):
        model = GptLM.trainable(cfg, {k: v.to(dev) for k, v in params.items()})
        loss = loss_fn(model, ids.to(dev))
        loss.backward()
        losses.append(float(loss.detach()))
        grads.append({n: p.grad.cpu() for n, p in model.named_parameters()})
    if fa.LAUNCHES != {"flash_fwd": 2, "flash_bwd_dq": 2, "flash_bwd_dkv": 2}:
        raise AssertionError(f"train_ref: launches {fa.LAUNCHES}, expected 2 of each")
    loss_err = abs(losses[0] - losses[1])
    grad_err = max(max_abs_err(grads[0][n], grads[1][n]) for n in grads[0])
    if not (loss_err <= 1e-4 and grad_err <= 1e-4) or not np.isfinite(losses[1]):
        raise AssertionError(f"train_ref: card vs CPU loss {loss_err}, grads {grad_err}")
    emit(phase="train_ref", card=card, loss=losses[1], loss_abs_err=loss_err,
         grad_max_abs_err=grad_err, n_grads=len(grads[0]))


TRAIN_BATCH, TRAIN_SEQ, TRAIN_STEPS = 8, 1024, 8


def train_phase(card: str):
    """The bench's GPT train step at full width through the kernels, then
    through the plain attention from the same weights. The kernel run's
    per-step ``attribution`` row is held by :func:`check_attribution`.
    Returns the flash kernels' launches of the kernel run."""
    from kubeflow_tpu_torch.models.gpt import causal_plain_attention
    from kubeflow_tpu_torch.ops import flash_attention as fa
    from kubeflow_tpu_torch.training.attribution import attribute_gpt
    from kubeflow_tpu_torch.training.flops import detect_generation
    from kubeflow_tpu_torch.training.gpt import bench_config, train

    cfg = bench_config(TRAIN_SEQ)
    runs = {}
    for label, attn in (("kernel", None), ("plain", causal_plain_attention)):
        gc.collect()
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
        kw = {} if attn is None else {"attention_fn": attn}
        clock = EventClock()
        fa.reset_launches()
        res = train(cfg, batch=TRAIN_BATCH, seq=TRAIN_SEQ, steps=TRAIN_STEPS, seed=0,
                    device="cuda", clock=clock, **kw)
        launches = dict(fa.LAUNCHES)
        losses = res["losses"]
        steady = float(np.median(res["step_ms"][1:]))
        tokens = res["tokens_per_step"]
        runs[label] = res
        emit(phase="train", path=label, card=card, batch=TRAIN_BATCH, seq=TRAIN_SEQ,
             n_params=res["n_params"], losses=losses, step_ms=res["step_ms"],
             step_ms_median=steady, tokens_per_s=tokens / steady * 1e3, mfu=res["mfu"],
             flops_per_step=res["flops_per_step"],
             analytic_flops_per_step=res["analytic_flops_per_step"],
             counted_over_analytic=res["flops_per_step"] / res["analytic_flops_per_step"],
             step_breakdown=res["step_breakdown"],
             peak_mem_gib=res["peak_hbm_bytes"] / 2**30, launches=launches)
        if not all(np.isfinite(losses)) or not losses[-1] < losses[0]:
            raise AssertionError(f"train {label}: losses {losses}")
        # train() first runs the counted reference step (FLOPs) through the
        # same attention, then the 8 steps
        want = cfg.n_layers * (TRAIN_STEPS + 1) if attn is None else 0
        if any(n != want for n in launches.values()):
            raise AssertionError(f"train {label}: launches {launches}, expected {want} each")
        if attn is None:
            kernel_launches = launches
            gen = detect_generation("cuda")
            check_attribution("gpt", card, res, clock, attribute_gpt(
                cfg, batch=TRAIN_BATCH, seq=TRAIN_SEQ, generation=gen), gen, phase="train")
    lk, lp = runs["kernel"]["losses"], runs["plain"]["losses"]
    first, worst = abs(lk[0] - lp[0]), max(abs(a - c) for a, c in zip(lk, lp))
    if not (first <= 0.02 and worst <= 0.05):
        raise AssertionError(f"train: kernel vs plain losses differ: step 1 {first}, "
                             f"worst {worst}")
    emit(phase="train", card=card, step1_loss_diff=first, max_loss_diff=worst)
    gc.collect()
    torch.cuda.empty_cache()
    return kernel_launches


def train_profile_phase(card: str) -> None:
    """The bench config's train step: host ms of 3 unprofiled steps after a
    warm-up step, then one step under torch.profiler after a warm-up cycle:
    device-busy share of that step's wall time, the top kernels, and the
    flash kernels' share (every one of their launches must be in the trace,
    each the tensor-core kernel: the step is bf16).
    The profiled step's device ms over the unprofiled steps' host ms is an
    estimate of the busy share without the profiler."""
    from kubeflow_tpu_torch.models.gpt import GptLM, init_params
    from kubeflow_tpu_torch.training.gpt import bench_config, make_optimizer, train_step

    cfg = bench_config(TRAIN_SEQ)
    model = GptLM.trainable(cfg, init_params(cfg, seed=0, device="cuda"))
    opt = make_optimizer(model.parameters())
    ids = torch.as_tensor(np.random.default_rng(0).integers(
        0, cfg.vocab_size, (TRAIN_BATCH, TRAIN_SEQ)), device="cuda")

    def step():
        float(train_step(model, opt, ids))  # the read waits for the device
        torch.cuda.synchronize()

    step()
    unprofiled_ms = []
    for _ in range(3):
        t0 = time.perf_counter()
        step()
        unprofiled_ms.append((time.perf_counter() - t0) * 1e3)
    step_ms = float(np.median(unprofiled_ms))
    prof, wall_ms = whole_profile(step, ("cpu", "cuda"), 3 * cfg.n_layers)
    by_name = device_ms_by_kernel(prof)
    device_ms = sum(by_name.values())
    names = ("flash_fwd", "flash_bwd_dq", "flash_bwd_dkv")
    seen = {n: len(cuda_kernel_ms(prof, n + "_kernel_mma")) for n in names}
    if seen != {n: cfg.n_layers for n in names}:
        raise AssertionError(f"train_profile: the trace holds {seen} tensor-core flash "
                             f"launches, expected {cfg.n_layers} of each")
    flash_ms = {n: sum(cuda_kernel_ms(prof, n + "_kernel_mma")) for n in names}
    top = sorted(by_name.items(), key=lambda kv: -kv[1])[:10]
    emit(phase="train_profile", card=card, step_ms_unprofiled=unprofiled_ms,
         step_wall_ms=wall_ms, device_ms=device_ms,
         device_busy_share=device_ms / wall_ms,
         device_ms_over_unprofiled_step_ms=device_ms / step_ms,
         flash_ms=flash_ms, flash_launches_seen=seen,
         flash_share_of_device=sum(flash_ms.values()) / device_ms,
         flash_share_of_step=sum(flash_ms.values()) / wall_ms,
         top_kernels_ms=[[n[:90], ms] for n, ms in top])
    del model, opt
    gc.collect()
    torch.cuda.empty_cache()


# -- phases 12-15: ResNet-50 training ---------------------------------------------

FB_SOURCE = "kubeflow_tpu_torch/ops/csrc/fused_bottleneck.cu"
FB_REPLACES = {
    "fused_bottleneck": "kubeflow_tpu/ops/fused_bottleneck.py:76 (_kernel, pallas_call :144)",
    "fused_transition":
        "kubeflow_tpu/ops/fused_bottleneck.py:237 (_transition_kernel, pallas_call :325)",
}
#: the profiler name of each kernel on the bf16 path: a launch of the f32
#: x's kernels there (``fused_bottleneck_kernel<float>``,
#: ``fused_transition_kernel<float, S>``, whose names do not hold these)
#: fails phases resnet_kernels and resnet_profile
FB_MATCH = {"fused_bottleneck": "fused_bottleneck_kernel_mma",
            "fused_transition": "fused_transition_kernel_mma"}
RESNET_BATCH, RESNET_STEPS = 256, 8
#: ResNet-50's block shapes at 224 x 224 and how many blocks of each a step
#: runs: (hw, stride, cin, cmid, cout, blocks)
FB_SHAPES = {
    "fused_bottleneck": [(56, 1, 256, 64, 256, 2), (28, 1, 512, 128, 512, 3),
                         (14, 1, 1024, 256, 1024, 5), (7, 1, 2048, 512, 2048, 2)],
    "fused_transition": [(56, 1, 64, 64, 256, 1), (56, 2, 256, 128, 512, 1),
                         (28, 2, 512, 256, 1024, 1), (14, 2, 1024, 512, 2048, 1)],
}


def fb_inputs(n, hw, cin, cmid, cout, proj, seed):
    """A block's inputs on the card: bf16 x >= 0 (a relu's output), f32
    weights at a lecun scale, folded norms near (1, 0)."""
    g = torch.Generator(device="cuda").manual_seed(seed)
    r = lambda *s: torch.randn(*s, generator=g, device="cuda")  # noqa: E731
    args = [torch.relu(r(n, hw, hw, cin)).to(torch.bfloat16),
            r(cin, cmid) / cin ** 0.5, 1 + 0.1 * r(cmid), 0.1 * r(cmid),
            r(3, 3, cmid, cmid) / (9 * cmid) ** 0.5, 1 + 0.1 * r(cmid), 0.1 * r(cmid),
            r(cmid, cout) / cmid ** 0.5, 1 + 0.1 * r(cout), 0.1 * r(cout)]
    if proj:
        args += [r(cin, cout) / cin ** 0.5, 1 + 0.1 * r(cout), 0.1 * r(cout)]
    return args


def fb_bound(n, hw, stride, cin, cmid, cout, proj):
    """Least time (ms) of one block at these shapes and what bounds it: the
    dots at the bf16 rate, or x read once, y written once and the f32
    weights, scales and biases read once at the HBM rate."""
    ho = hw // stride
    flops = 2.0 * n * (hw * hw * cin * cmid
                       + ho * ho * (9 * cmid * cmid + cmid * cout + (cin * cout if proj else 0)))
    weights = cin * cmid + 9 * cmid * cmid + cmid * cout + (cin * cout if proj else 0)
    norms = 2 * (2 * cmid + cout + (cout if proj else 0))
    nbytes = 2 * n * hw * hw * cin + 2 * n * ho * ho * cout + 4 * (weights + norms)
    t_ops, t_bytes = flops / BF16_FLOPS_PER_S * 1e3, nbytes / HBM_BYTES_PER_S * 1e3
    return dict(bound_ms=max(t_ops, t_bytes),
                bound_by="operations" if t_ops >= t_bytes else "bytes",
                flops=flops, bytes=nbytes)


def fb_library(args, stride, proj):
    """The same block as cuDNN ``F.conv2d`` calls on bf16 channels_last
    tensors with the same epilogue (bf16 scales): several PyTorch calls."""
    import torch.nn.functional as F

    bf = torch.bfloat16
    x = args[0].permute(0, 3, 1, 2)
    w1, s1, b1, w2, s2, b2, w3, s3, b3 = args[1:10]
    conv1x1 = lambda w: w.t()[:, :, None, None].to(bf).contiguous()  # noqa: E731
    col = lambda v: v.to(bf)[None, :, None, None]  # noqa: E731
    w1c, w3c = conv1x1(w1), conv1x1(w3)
    w2c = w2.permute(3, 2, 0, 1).to(bf).contiguous(memory_format=torch.channels_last)
    a1, a2, a3 = (col(s1), col(b1)), (col(s2), col(b2)), (col(s3), col(b3))
    wpc, ap = (conv1x1(args[10]), (col(args[11]), col(args[12]))) if proj else (None, None)

    def run():
        h = torch.relu_(torch.addcmul(a1[1], F.conv2d(x, w1c), a1[0]))
        if stride == 2:  # XLA's SAME (0, 1)
            h = F.conv2d(F.pad(h, (0, 1, 0, 1)), w2c, stride=2)
        else:
            h = F.conv2d(h, w2c, padding=1)
        h = torch.relu_(torch.addcmul(a2[1], h, a2[0]))
        y = torch.addcmul(a3[1], F.conv2d(h, w3c), a3[0])
        if proj:
            y = y + torch.addcmul(ap[1], F.conv2d(x, wpc, stride=stride), ap[0])
        else:
            y = y + x
        return torch.relu_(y)

    return run


def resnet_kernels_phase(card: str):
    """Each fused-block kernel at each of its ResNet-50 shapes, batch 256,
    bf16 x: twice for the same bits, against its plain version (max abs
    error at most 1e-2 of the output's largest magnitude, about one bf16 ULP:
    the kernel sums in another f32 order, which can flip one bf16 rounding
    of h1 or h2), then times beside the bound, the plain version and the
    cuDNN yardstick, by call and on the device (every kernel it launches).
    The device time is read from the kernel's profiler name in FB_MATCH, so
    a launch of another kernel fails the phase. Returns each kernel's entry
    for the kernels line, its times summed over the blocks of one training
    step."""
    from kubeflow_tpu_torch.ops import fused_bottleneck as fb

    n = RESNET_BATCH
    results = {}
    for name, shapes in FB_SHAPES.items():
        proj = name == "fused_transition"
        total = dict(ms=0.0, device_ms=0.0, plain_ms=0.0, library_ms=0.0,
                     library_device_ms=0.0, bound_ms=0.0, flops=0.0, bytes=0.0)
        worst = 0.0
        for seed, (hw, stride, cin, cmid, cout, blocks) in enumerate(shapes):
            args = fb_inputs(n, hw, cin, cmid, cout, proj, seed)
            if proj:
                call = lambda: fb.fused_transition(*args, stride=stride)  # noqa: E731
                plain = lambda: fb.fused_transition_plain(*args, stride=stride)  # noqa: E731
            else:
                call = lambda: fb.fused_bottleneck(*args)  # noqa: E731
                plain = lambda: fb.fused_bottleneck_plain(*args)  # noqa: E731
            y1, y2, want = call(), call(), plain()
            torch.cuda.synchronize()
            if not torch.equal(y1, y2):
                raise AssertionError(f"{name} {hw}: two runs differ")
            err, top = max_abs_err(y1, want), float(want.float().abs().max())
            if not (torch.isfinite(y1.float()).all() and err <= 1e-2 * top):
                raise AssertionError(f"{name} {hw}: kernel vs plain {err} (max {top})")
            del y1, y2, want
            ms = cuda_ms(call, iters=20, warmup=3)
            dev_ms = kernel_device_ms(call, FB_MATCH[name], iters=10)
            plain_ms = cuda_ms(plain, iters=5, warmup=2)
            library = fb_library(args, stride, proj)
            library_ms = cuda_ms(library, iters=20, warmup=3)
            lib_dev_ms, lib_names = library_device_ms(library, iters=10)
            lib_names = [n[:90] for n in lib_names]
            bd = fb_bound(n, hw, stride, cin, cmid, cout, proj)
            worst = max(worst, err)
            for key, value in (("ms", ms), ("device_ms", dev_ms), ("plain_ms", plain_ms),
                               ("library_ms", library_ms), ("library_device_ms", lib_dev_ms),
                               ("bound_ms", bd["bound_ms"]),
                               ("flops", bd["flops"]), ("bytes", bd["bytes"])):
                total[key] += blocks * value
            emit(phase="resnet_kernels", kernel=name, card=card,
                 shape=dict(n=n, hw=hw, stride=stride, cin=cin, cmid=cmid, cout=cout),
                 blocks_per_step=blocks, match=FB_MATCH[name],
                 band=fb.plan_for(torch.bfloat16, hw, stride, cin, cmid, cout, proj),
                 max_abs_err=err, max_abs=top, deterministic=True, kernel_ms=ms,
                 kernel_device_ms=dev_ms, plain_ms=plain_ms,
                 library_ms=library_ms, library="cuDNN conv2d x3-4 + addcmul/relu (bf16)",
                 library_device_ms=lib_dev_ms, library_kernels=lib_names,
                 device_over_library_device=dev_ms / lib_dev_ms,
                 bound_ms=bd["bound_ms"], bound_by=bd["bound_by"], flops=bd["flops"],
                 bytes=bd["bytes"], achieved_tflops=bd["flops"] / dev_ms / 1e9,
                 bound_share=bd["bound_ms"] / dev_ms)
            del args
        t_ops = total["flops"] / BF16_FLOPS_PER_S
        t_bytes = total["bytes"] / HBM_BYTES_PER_S
        results[name] = dict(name=name, route="cuda", source=FB_SOURCE,
                             replaces=FB_REPLACES[name], max_abs_err=worst, ms=total["ms"],
                             plain_ms=total["plain_ms"], bound_ms=total["bound_ms"],
                             bound_by="operations" if t_ops >= t_bytes else "bytes",
                             library_ms=total["library_ms"])
        emit(phase="resnet_kernels", kernel=name, card=card, per_step_of_blocks=True,
             kernel_ms=total["ms"], kernel_device_ms=total["device_ms"],
             plain_ms=total["plain_ms"], library_ms=total["library_ms"],
             library_device_ms=total["library_device_ms"],
             device_over_library_device=total["device_ms"] / total["library_device_ms"],
             achieved_tflops=total["flops"] / total["device_ms"] / 1e9,
             bound_ms=total["bound_ms"], max_abs_err=worst)
    # odd hw at stride 2 has no SAME (0, 1) form: the wrapper raises
    odd = fb_inputs(2, 7, 64, 64, 256, True, 99)
    try:
        fb.fused_transition(*odd, stride=2)
    except ValueError:
        pass
    else:
        raise AssertionError("fused_transition took an odd hw at stride 2")
    gc.collect()
    torch.cuda.empty_cache()
    return results


def resnet_ref_phase(card: str) -> None:
    """A tiny fused ResNet with f32 activations (two stages of two blocks,
    16 filters, 32 x 32): loss and every gradient through the kernels on the
    card against the plain path on the CPU, from the same weights, with
    cuDNN and matmul TF32 off. The kernels round their dots to bf16 as the
    plain versions do but sum in another order, which can flip the bf16
    rounding of an h1 or h2 element (a relative 3.9e-3); the tolerances
    (loss 1e-3, each gradient 2e-2 of its largest magnitude) leave room for
    a few such flips, and nothing more."""
    from kubeflow_tpu_torch.models.resnet import BottleneckBlock, ResNet
    from kubeflow_tpu_torch.ops import fused_bottleneck as fb
    from kubeflow_tpu_torch.training.classifier import cross_entropy_loss

    rng = np.random.default_rng(5)
    x = torch.as_tensor(rng.standard_normal((4, 32, 32, 3), dtype=np.float32))
    y = torch.as_tensor(rng.integers(0, 10, 4))
    losses, grads = [], []
    fb.reset_launches()
    with fb.f32_convolutions():
        for dev in ("cpu", "cuda"):
            model = ResNet([2, 2], BottleneckBlock, num_classes=10, num_filters=16,
                           stem="s2d", fused_blocks=True, dtype=torch.float32, seed=4,
                           device=dev)
            loss = cross_entropy_loss(model(x.to(dev), train=True), y.to(dev))
            loss.backward()
            losses.append(float(loss.detach()))
            grads.append({n: p.grad.cpu() for n, p in model.named_parameters()})
    if fb.LAUNCHES != {"fused_bottleneck": 2, "fused_transition": 2}:
        raise AssertionError(f"resnet_ref: launches {fb.LAUNCHES}, expected 2 of each")
    loss_err = abs(losses[0] - losses[1])
    rel = {n: max_abs_err(grads[0][n], grads[1][n]) / max(float(grads[0][n].abs().max()), 1e-12)
           for n in grads[0]}
    worst = max(rel, key=rel.get)
    if not (loss_err <= 1e-3 and rel[worst] <= 2e-2) or not np.isfinite(losses[1]):
        raise AssertionError(f"resnet_ref: card vs CPU loss {loss_err}, grad {worst} {rel[worst]}")
    emit(phase="resnet_ref", card=card, loss=losses[1], loss_abs_err=loss_err,
         grad_max_rel_err=rel[worst], worst_grad=worst, n_grads=len(rel))


def resnet_train_phase(card: str):
    """The bench's ResNet-50 step at full width and depth (batch 256, 224 x
    224, s2d stem, SGD-momentum), 8 steps through the kernels, then the same
    8 steps from the same weights through the kernels' plain versions, then
    4 steps of the unfused model (batch-stat BatchNorm through cuDNN; a
    different function, timed only). The kernel run's per-step
    ``attribution`` row is held by :func:`check_attribution`. Returns the
    kernels' launches of the kernel run."""
    from kubeflow_tpu_torch.ops import fused_bottleneck as fb
    from kubeflow_tpu_torch.training.attribution import attribute_resnet
    from kubeflow_tpu_torch.training.flops import detect_generation
    from kubeflow_tpu_torch.training.resnet import bench_config, train

    cfg = bench_config()
    runs = {}
    for label, kw, steps in (("kernel", {}, RESNET_STEPS),
                             ("plain", {"plain_kernels": True}, RESNET_STEPS),
                             ("unfused", {"fused_blocks": False}, 4)):
        gc.collect()
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
        clock = EventClock()
        fb.reset_launches()
        res = train(cfg, steps=steps, seed=0, device="cuda", clock=clock, **kw)
        launches = dict(fb.LAUNCHES)
        losses = res["losses"]
        steady = float(np.median(res["step_ms"][1:]))
        runs[label] = res
        emit(phase="resnet_train", path=label, card=card, batch=cfg.batch, image=cfg.image,
             n_params=res["n_params"], losses=losses, accuracy=res["accuracy"],
             step_ms=res["step_ms"], step_ms_median=steady,
             images_per_s=cfg.batch / steady * 1e3, mfu=res["mfu"],
             flops_per_step=res["flops_per_step"],
             analytic_flops_per_step=res["analytic_flops_per_step"],
             counted_over_analytic=res["flops_per_step"] / res["analytic_flops_per_step"],
             step_breakdown=res["step_breakdown"],
             peak_mem_gib=res["peak_hbm_bytes"] / 2**30, launches=launches)
        if not all(np.isfinite(losses)):
            raise AssertionError(f"resnet_train {label}: losses {losses}")
        want = ({"fused_bottleneck": 12 * steps, "fused_transition": 4 * steps}
                if label == "kernel" else {"fused_bottleneck": 0, "fused_transition": 0})
        if launches != want:
            raise AssertionError(f"resnet_train {label}: launches {launches}, expected {want}")
        if label == "kernel":
            kernel_launches = launches
            gen = detect_generation("cuda")
            check_attribution("resnet", card, res, clock, attribute_resnet(
                batch=cfg.batch, image=cfg.image, num_classes=cfg.num_classes, stem=cfg.stem,
                fused_blocks=True, stage_sizes=tuple(cfg.stage_sizes),
                num_filters=cfg.num_filters, generation=gen), gen, phase="resnet_train")
    lk, lp = runs["kernel"]["losses"], runs["plain"]["losses"]
    first, worst = abs(lk[0] - lp[0]), max(abs(a - c) for a, c in zip(lk, lp))
    if not (lk[0] == lk[1] and first <= 1e-2 and worst <= 5e-2):
        raise AssertionError(f"resnet_train: kernel vs plain losses differ: step 1 {first}, "
                             f"worst {worst} (or lr 0 at step 0 moved the loss)")
    emit(phase="resnet_train", card=card, step1_loss_diff=first, max_loss_diff=worst)
    gc.collect()
    torch.cuda.empty_cache()
    return kernel_launches


def resnet_profile_phase(card: str) -> None:
    """The bench ResNet-50 step: host ms of 3 unprofiled steps after a
    warm-up step, then one step under torch.profiler after a warm-up cycle:
    the device-busy share of its wall time, the top kernels, and the two
    fused-block kernels' share (all 16 of their launches must be in the
    trace)."""
    from kubeflow_tpu_torch.training.classifier import ClassifierTask, sgd_momentum
    from kubeflow_tpu_torch.training.resnet import bench_config, make_batch, make_model

    cfg = bench_config()
    images, labels = make_batch(cfg, 0, "cuda")
    task = ClassifierTask(make_model(cfg, device="cuda"),
                          lambda p: sgd_momentum(p, lr=cfg.lr, total_steps=cfg.total_steps))
    state = task.init()

    def step():
        float(task.train_step(state, images, labels)[1]["loss"])
        torch.cuda.synchronize()

    step()
    unprofiled_ms = []
    for _ in range(3):
        t0 = time.perf_counter()
        step()
        unprofiled_ms.append((time.perf_counter() - t0) * 1e3)
    prof, wall_ms = whole_profile(step, ("cpu", "cuda"), 16)
    by_name = device_ms_by_kernel(prof)
    device_ms = sum(by_name.values())
    seen = {n: len(cuda_kernel_ms(prof, FB_MATCH[n])) for n in FB_REPLACES}
    if seen != {"fused_bottleneck": 12, "fused_transition": 4}:
        raise AssertionError(f"resnet_profile: the trace holds {seen} fused-block launches")
    fb_ms = {n: sum(cuda_kernel_ms(prof, FB_MATCH[n])) for n in FB_REPLACES}
    top = sorted(by_name.items(), key=lambda kv: -kv[1])[:12]
    emit(phase="resnet_profile", card=card, step_ms_unprofiled=unprofiled_ms,
         step_wall_ms=wall_ms, device_ms=device_ms, device_busy_share=device_ms / wall_ms,
         device_ms_over_unprofiled_step_ms=device_ms / float(np.median(unprofiled_ms)),
         fused_ms=fb_ms, fused_launches_seen=seen,
         fused_share_of_device=sum(fb_ms.values()) / device_ms,
         top_kernels_ms=[[n[:90], ms] for n, ms in top])
    del task, state, images, labels
    gc.collect()
    torch.cuda.empty_cache()



# -- phases 19b-19c: the input pipeline, the checkpoint and the HPO trial ----------

#: steps of each resnet_data run
RESNET_DATA_STEPS = 4


def direct_batches(source, clock, split: dict):
    """No prefetch: each batch drawn and copied to the card on the training
    thread, inside ``clock.data_wait()``; ``split["draw_s"]`` and
    ``split["copy_s"]`` get each batch's host seconds of the two."""
    it = iter(source)
    while True:
        with clock.data_wait():
            t0 = time.perf_counter()
            item = next(it, None)
            if item is not None:
                t1 = time.perf_counter()
                item = {k: torch.from_numpy(v).to("cuda") for k, v in item.items()}
                torch.cuda.synchronize()
                split["draw_s"].append(t1 - t0)
                split["copy_s"].append(time.perf_counter() - t1)
        if item is None:
            return
        yield item


def resnet_data_phase(card: str) -> dict:
    """Phase 19b: the bench's ResNet-50 step (batch 256, 224 x 224, s2d
    stem, fused blocks, SGD-momentum) fed by ``synthetic_classifier_source``
    for ``RESNET_DATA_STEPS`` steps, (a) through ``DataPipeline`` (the
    producer thread's pinned, side-stream copies) and (b) with no prefetch
    (``direct_batches``), each from the same seeded weights under a
    ``StepClock``: ``data_wait_s_per_step``, step ms, images/s, finite
    losses, exactly 12 ``fused_bottleneck`` and 4 ``fused_transition``
    launches a step; both runs see the same batches, so their first losses
    agree within 1e-3. Then the model's variables saved as a flax tree
    (``resnet_params_to_flax``) through the ``Checkpointer``, restored into a
    fresh model (``resnet_params_from_flax``): every tensor bit-equal and
    the eval logits equal; the save and restore seconds and the bytes on
    disk. Returns the fused kernels' launches of both runs."""
    from kubeflow_tpu_torch.data import DataPipeline, synthetic_classifier_source
    from kubeflow_tpu_torch.gpu.profiling import StepClock, step_breakdown
    from kubeflow_tpu_torch.models.convert import resnet_params_from_flax, resnet_params_to_flax
    from kubeflow_tpu_torch.ops import fused_bottleneck as fb
    from kubeflow_tpu_torch.runtime.metrics import METRICS
    from kubeflow_tpu_torch.training.checkpoint import Checkpointer
    from kubeflow_tpu_torch.training.resnet import bench_config, make_model, make_task

    cfg = bench_config()
    n = RESNET_DATA_STEPS
    source = synthetic_classifier_source(cfg.batch, (cfg.image, cfg.image, 3),
                                         cfg.num_classes, steps=n)
    totals: Counter = Counter()
    losses = {}
    model = make_model(cfg, seed=0, device="cuda")
    init = {k: v.clone() for k, v in model.state_dict().items()}
    split = {"draw_s": [], "copy_s": []}
    for label in ("prefetch", "no_prefetch"):
        model.load_state_dict(init)  # both runs from the same weights
        task = make_task(cfg, model)
        state = task.init()
        clock = StepClock()
        batches = (iter(DataPipeline(source, device="cuda", clock=clock))
                   if label == "prefetch" else direct_batches(source(0), clock, split))
        torch.cuda.synchronize()
        fb.reset_launches()
        run_losses, step_ms = [], []
        clock.mark()
        for batch in batches:
            with clock.compute():
                state, metrics = task.train_step(state, batch["images"], batch["labels"].long())
            with clock.fetch():
                run_losses.append(float(metrics["loss"]))
            step_ms.append(clock.end_step()["total"] * 1e3)
        launches = dict(fb.LAUNCHES)
        waits = [st.get("data_wait", 0.0) for st in clock.steps]
        steady = float(np.median(step_ms[1:]))
        emit(phase="resnet_data", path=label, card=card, batch=cfg.batch, image=cfg.image,
             steps=len(run_losses), losses=run_losses, step_ms=step_ms,
             step_ms_median=steady, images_per_s=cfg.batch / steady * 1e3,
             data_wait_s=waits, data_wait_s_median_after_first=float(np.median(waits[1:])),
             step_breakdown=step_breakdown(clock), launches=launches,
             **({"draw_s": split["draw_s"], "copy_s": split["copy_s"]}
                if label == "no_prefetch" else {}))
        want = {"fused_bottleneck": 12 * n, "fused_transition": 4 * n}
        if len(run_losses) != n or not all(np.isfinite(run_losses)) or launches != want:
            raise AssertionError(f"resnet_data {label}: {len(run_losses)} steps, losses "
                                 f"{run_losses}, launches {launches}; expected {want}")
        totals.update(launches)
        losses[label] = run_losses
    images = batch["images"]
    del init
    first = abs(losses["prefetch"][0] - losses["no_prefetch"][0])
    if first > 1e-3:
        raise AssertionError(f"resnet_data: the runs' first losses differ by {first}")

    # the variables through the checkpoint into a fresh model
    with tempfile.TemporaryDirectory(prefix="chip_smoke_resnet_") as ckdir:
        save0, restore0 = checkpoint_seconds(METRICS)
        Checkpointer(ckdir).save(n, resnet_params_to_flax(model.state_dict(), model),
                                meta={"steps": n})
        tree, meta = Checkpointer(ckdir).restore_numpy()
        save1, restore1 = checkpoint_seconds(METRICS)
        disk_bytes = dir_bytes(ckdir)
    fresh = make_model(cfg, seed=1, device="cuda")
    fresh.load_state_dict(resnet_params_from_flax(tree, fresh))
    want, got = model.state_dict(), fresh.state_dict()
    unequal = [k for k in want if not torch.equal(want[k], got[k])]
    with torch.no_grad():
        equal_logits = torch.equal(model(images, train=False), fresh(images, train=False))
    emit(phase="resnet_data", card=card, first_loss_diff=first, checkpoint_meta=meta,
         checkpoint_tensors=len(want), checkpoint_save_s=save1 - save0,
         checkpoint_restore_s=restore1 - restore0, checkpoint_disk_bytes=disk_bytes,
         restored_bit_equal=not unequal, eval_logits_equal=equal_logits)
    if unequal or not equal_logits or meta != {"steps": n}:
        raise AssertionError(f"resnet_data: restored tensors differ at {unequal[:5]}, eval "
                             f"logits equal {equal_logits}, meta {meta}")
    del model, task, state, fresh, tree, images, batch
    gc.collect()
    torch.cuda.empty_cache()
    return dict(totals)


#: the trial's hyperparameters (JAX's ``mnist_objective`` defaults otherwise)
MNIST_PARAMS = {"lr": 1e-2, "dropout": 0.1, "width": 16}


def mnist_trial_phase(card: str) -> None:
    """Phase 19c: the HPO trial ``mnist_objective`` on the card at JAX's
    defaults (30 steps, batch 64), a report every step: the loss falls and
    the accuracy lies in [0, 1]; then again with a ``report_fn`` that
    returns False at step 10: it stops there (reports at 5 and 10) and
    returns that report's metrics. Seconds of each trial."""
    from kubeflow_tpu_torch.hpo.trials import mnist_objective

    curve = []
    t0 = time.perf_counter()
    full = mnist_objective(MNIST_PARAMS, device="cuda", report_every=1,
                           report_fn=lambda step, m: curve.append(m["loss"]) or True)
    full_s = time.perf_counter() - t0
    seen = []

    def stop_at_10(step, m):
        seen.append((step, m))
        return step < 10

    t0 = time.perf_counter()
    stopped = mnist_objective(MNIST_PARAMS, device="cuda", report_fn=stop_at_10)
    stopped_s = time.perf_counter() - t0
    emit(phase="mnist_trial", card=card, params=MNIST_PARAMS, steps=30, batch=64,
         result=full, loss_first=curve[0], trial_s=full_s,
         early_stop_reports=[s for s, _ in seen], early_stop_result=stopped,
         early_stop_trial_s=stopped_s)
    if not (np.isfinite(full["loss"]) and full["loss"] < curve[0]
            and 0.0 <= full["accuracy"] <= 1.0 and len(curve) == 29):
        raise AssertionError(f"mnist_trial: loss {curve[0]} -> {full['loss']}, accuracy "
                             f"{full['accuracy']}, {len(curve)} reports")
    if [s for s, _ in seen] != [5, 10] or stopped != seen[-1][1]:
        raise AssertionError(f"mnist_trial: reports {seen}, result {stopped}")


# -- phases 19d-19g: the profile server, the serving probe, the ResNet probes ---------

#: steps of phase 19d's training loop
PROFILE_CLOCK_STEPS = 8


def http_status(port: int, path: str) -> int:
    try:
        with urllib.request.urlopen(f"http://127.0.0.1:{port}{path}", timeout=60) as resp:
            return resp.status
    except urllib.error.HTTPError as e:
        return e.code


def profile_clock_phase(card: str, device: str = "cuda") -> dict:
    """Phase 19d: the bench's GPT training loop (b 8, L 1024, AdamW) for
    ``PROFILE_CLOCK_STEPS`` steps in a thread, its ``StepClock``
    registered as "train" (``register_profile_clock``); the profile server
    started on port 0 (a second port refused); after step 2,
    ``/debug/profile?clock=train&steps=2&timeout=60`` over HTTP returns
    exactly 2 steps recorded after the request, consecutive, each with its
    compute and fetch phases; an unknown clock answers 404 and a
    non-numeric ``steps`` 400; each flash kernel 24 launches a step.
    Returns the flash kernels' launches of the loop."""
    from kubeflow_tpu_torch.gpu import profiling as prof
    from kubeflow_tpu_torch.models.gpt import GptLM, init_params
    from kubeflow_tpu_torch.ops import flash_attention as fa
    from kubeflow_tpu_torch.training.gpt import bench_config, make_optimizer, train_step

    cfg = bench_config(TRAIN_SEQ)
    ids = torch.as_tensor(np.random.default_rng(0).integers(
        0, cfg.vocab_size, (TRAIN_BATCH, TRAIN_SEQ)), dtype=torch.int64, device=device)
    model = GptLM.trainable(cfg, init_params(cfg, seed=0, device=device))
    opt = make_optimizer(model.parameters())
    clock = prof.register_profile_clock(prof.StepClock(), name="train")
    port = prof.start_profile_server(0)
    try:
        prof.start_profile_server(port + 1)
        raise AssertionError("profile_clock: a second profile server port was accepted")
    except RuntimeError as e:
        if f"already on port {port}" not in str(e):
            raise
    losses, errors = [], []

    def loop():
        try:
            for _ in range(PROFILE_CLOCK_STEPS):
                with clock.compute():
                    loss_t = train_step(model, opt, ids)
                with clock.fetch():
                    losses.append(float(loss_t))
                clock.end_step()
        except Exception as e:  # surfaced below, after the join
            errors.append(e)

    if device == "cuda":
        torch.cuda.synchronize()
    fa.reset_launches()
    t0 = time.perf_counter()
    worker = threading.Thread(target=loop, name="profile-clock-train")
    worker.start()
    deadline = time.monotonic() + 600
    while len(clock.steps) < 2 and worker.is_alive() and time.monotonic() < deadline:
        time.sleep(0.005)
    baseline = len(clock.steps)
    t_req = time.perf_counter()
    doc = get_json(port, "/debug/profile?clock=train&steps=2&timeout=60")
    capture_s = time.perf_counter() - t_req
    statuses = {"nope": http_status(port, "/debug/profile?clock=nope"),
                "many": http_status(port, "/debug/profile?steps=many")}
    worker.join(timeout=600)
    wall = time.perf_counter() - t0
    launches = dict(fa.LAUNCHES)
    prof._PROFILE_CLOCKS.pop("train", None)
    if errors or worker.is_alive():
        raise AssertionError(f"profile_clock: the training loop failed: {errors}")
    steps = [e for e in doc["traceEvents"] if e["cat"] == "step"]
    numbers = [e["args"]["step"] for e in steps]
    phases = {n: sorted(e["name"] for e in doc["traceEvents"]
                        if e["cat"] == "phase" and e["args"]["step"] == n) for n in numbers}
    emit(phase="profile_clock", card=card, port=port, steps=PROFILE_CLOCK_STEPS,
         baseline_steps=baseline, captured_steps=numbers, captured_phases=phases,
         capture_s=capture_s, statuses=statuses, losses=losses, wall_s=wall,
         step_ms=[r["total"] * 1e3 for r in clock.steps], launches=launches,
         display_time_unit=doc["displayTimeUnit"])
    if (len(numbers) != 2 or numbers[0] <= baseline or numbers[1] != numbers[0] + 1
            or any(v != ["compute", "fetch"] for v in phases.values())):
        raise AssertionError(f"profile_clock: captured steps {numbers} (baseline {baseline}), "
                             f"phases {phases}")
    if statuses != {"nope": 404, "many": 400}:
        raise AssertionError(f"profile_clock: statuses {statuses}")
    if not all(np.isfinite(losses)) or len(losses) != PROFILE_CLOCK_STEPS \
            or not losses[-1] < losses[0]:
        raise AssertionError(f"profile_clock: losses {losses}")
    want = cfg.n_layers * PROFILE_CLOCK_STEPS
    if any(n != want for n in launches.values()):
        raise AssertionError(f"profile_clock: launches {launches}, expected {want} each")
    del model, opt
    cleanup()
    return launches


#: the serving probe's depth cuts (JAX's defaults in the comments)
SB_BERT_REQUESTS = 8        # timed requests a bucket [40]
SB_DECODE_NEW = 32          # new tokens of bench_gpt_decode [256]
SB_REQUESTS = 8             # requests of bench_continuous, at 8 slots [16]
SB_BUDGETS = (16, 24, 32, 40)  # their new tokens, cycled [32/64/128/224]
SB_DISTILL_STEPS = 20       # the distilled draft's steps [300]
SB_DISAGG_REQUESTS = 3      # requests of bench_disagg [24]
SB_DISAGG_BUDGET = 16       # their new tokens [128]
#: BERT-base's flash_fwd launches a forward (one a layer)
BERT_LAYERS = 12


class LaunchWindow:
    """The KV and flash kernels' launches and the engines' decode steps and
    spec rounds since the window opened or was last taken (the registry is
    not reset in between)."""

    def __init__(self) -> None:
        self.base = self._now()

    @staticmethod
    def _now() -> dict:
        from kubeflow_tpu_torch.ops import flash_attention as fa, kv_cache as kc
        from kubeflow_tpu_torch.runtime.metrics import METRICS

        return {**kc.LAUNCHES, **fa.LAUNCHES,
                "steps": METRICS.value("serving_decode_steps_total"),
                "rounds": METRICS.value("serving_spec_rounds_total")}

    def take(self) -> dict:
        now = self._now()
        out = {k: int(now[k] - self.base[k]) for k in now}
        self.base = now
        return out


def expect_none(label: str, counts: dict, *allowed: str) -> None:
    bad = {k: n for k, n in counts.items() if n and k not in allowed + ("steps", "rounds")}
    if bad:
        raise AssertionError(f"{label}: unexpected launches {bad}")


def serving_bench_phase(card: str, device: str = "cuda") -> dict:
    """Phase 19e: ``kubeflow_tpu_torch.e2e.serving_bench``'s four passes at
    full width (BERT-base at L 128; GPT-medium, d 1024, 24 layers), cut in
    depth (``SB_*``), each with a fresh registry as in its own process. (1)
    BERT over HTTP, buckets 1/8/32: ``flash_fwd`` 12 a forward, nothing
    else. (2) Static decoding at batch 1 and 8: no kernel (``generate()``
    writes its scalar-cursor cache by an indexed store, as JAX's
    ``dynamic_update_slice``; its attention is not flash). (3) The engine
    pass: the static path launches nothing; the paged continuous engine
    ``kv_block_update_pair`` 24 a decode step; distillation 24 + 6
    ``flash_fwd`` and 6 of each backward a step; the spec engine
    ``kv_row_update_pair`` 6 x 4 a round and no decode step; each request's
    continuous and spec tokens held to the static path's (``near_tie``).
    (4) The fleet: every request "ok", one KV import a request,
    ``kv_block_update_quant_pair`` 24 a decode step on the decode pool.
    Every row printed. Returns the kernels' launches of (1), (3) and (4),
    and the four passes' rows (for 22a's serving row)."""
    from kubeflow_tpu_torch.e2e import serving_bench as sb
    from kubeflow_tpu_torch.models.gpt import GptConfig
    from kubeflow_tpu_torch.runtime.metrics import METRICS

    n_layers = GptConfig.base().n_layers
    totals: Counter = Counter()
    passes = {}

    # (1) BERT-base predict over HTTP
    batches = (1, 8, 32)
    METRICS.reset()
    w = LaunchWindow()
    t0 = time.perf_counter()
    rows = passes["bert"] = sb.bench_bert_http(batches, SB_BERT_REQUESTS, device=device)
    c = w.take()
    for r in rows:
        emit(phase="serving_bench", metric="bert_base_predict_http", card=card,
             requests_per_batch=SB_BERT_REQUESTS, **r)
    forwards = len(batches) * (1 + SB_BERT_REQUESTS)
    expect_none("serving_bench_bert", c, "flash_fwd")
    if c["flash_fwd"] != BERT_LAYERS * forwards:
        raise AssertionError(f"serving_bench_bert: {c['flash_fwd']} flash_fwd launches over "
                             f"{forwards} forwards")
    emit(phase="serving_bench", run="bert", card=card, wall_s=time.perf_counter() - t0,
         launches=c)
    totals["flash_fwd"] += c["flash_fwd"]
    cleanup()

    # (2) static decoding
    t0 = time.perf_counter()
    rows = passes["decode"] = sb.bench_gpt_decode(new_tokens=SB_DECODE_NEW, device=device)
    c = w.take()
    for r in rows:
        emit(phase="serving_bench", metric="gpt_medium_kv_decode", card=card,
             new_tokens=SB_DECODE_NEW, **r)
    expect_none("serving_bench_decode", c)
    emit(phase="serving_bench", run="decode", card=card, wall_s=time.perf_counter() - t0,
         launches=c)
    cleanup()

    # (3) static vs continuous batching, then the speculative pass
    METRICS.reset()
    w = LaunchWindow()
    seen = {}
    t0 = time.perf_counter()
    row = passes["continuous"] = sb.bench_continuous(
        n_requests=SB_REQUESTS, budgets=SB_BUDGETS, distill_steps=SB_DISTILL_STEPS,
        device=device, observe=lambda stage, info: seen.__setitem__(
            stage, (info, w.take(), time.perf_counter())))
    emit(phase="serving_bench", metric="gpt_continuous_batching", card=card, **row)
    static, c, _ = seen["static"]
    expect_none("serving_bench_static", c)
    _, c, _ = seen["continuous"]
    expect_pair("serving_bench_continuous", c, "kv_block_update_pair", c["steps"], n_layers)
    if c["rounds"]:
        raise AssertionError(f"serving_bench_continuous: {c['rounds']} spec rounds")
    totals["kv_block_update_pair"] += c["kv_block_update_pair"]
    distill, c, _ = seen["distill"]
    dl = distill["draft_cfg"].n_layers
    expect_none("serving_bench_distill", c, "flash_fwd", "flash_bwd_dq", "flash_bwd_dkv")
    want = {"flash_fwd": (n_layers + dl) * SB_DISTILL_STEPS,
            "flash_bwd_dq": dl * SB_DISTILL_STEPS, "flash_bwd_dkv": dl * SB_DISTILL_STEPS}
    if {k: c[k] for k in want} != want:
        raise AssertionError(f"serving_bench_distill: launches {c}, expected {want}")
    for k in want:
        totals[k] += c[k]
    spec, c, _ = seen["spec"]
    if spec["spec_k"] != SPEC_K:
        raise AssertionError(f"serving_bench_spec: spec_k {spec['spec_k']}")
    expect_spec("serving_bench_spec", c, c["rounds"], c["steps"], dl)
    totals["kv_row_update_pair"] += c["kv_row_update_pair"]
    cfg, params, prompts = static["cfg"], static["params"], static["prompts"]
    differ = {name: hold_tokens(f"serving_bench_{name}", card, cfg, params, prompts,
                                seen[name][0]["tokens"], static["tokens"])
              for name in ("continuous", "spec")}
    emit(phase="serving_bench", run="continuous", card=card, wall_s=time.perf_counter() - t0,
         requests=SB_REQUESTS, distill_steps=SB_DISTILL_STEPS, draft_layers=dl,
         near_tie_differences=differ,
         equal_to_static={k: SB_REQUESTS - n for k, n in differ.items()},
         launches={k: v[1] for k, v in seen.items()})
    del seen, static, params
    cleanup()

    # (4) two models over prefill and decode pools, int8 KV
    METRICS.reset()
    w = LaunchWindow()
    seen = {}
    t0 = time.perf_counter()
    row = passes["disagg"] = sb.bench_disagg(
        n_requests=SB_DISAGG_REQUESTS, budget=SB_DISAGG_BUDGET, device=device,
        observe=lambda stage, info: seen.__setitem__(stage, info))
    c = w.take()
    emit(phase="serving_bench", metric="decode_tok_s_heterogeneous", card=card,
         value=row["decode_tok_s_heterogeneous"], **row)
    reqs = seen["disagg"]["requests"] + seen["disagg"]["warm"]
    reasons = Counter(r.finish_reason for r in reqs)
    imports = METRICS.value("serving_kv_import_total")
    if reasons != {"ok": len(reqs)} or imports != len(reqs):
        raise AssertionError(f"serving_bench_disagg: finish reasons {dict(reasons)}, "
                             f"{imports} KV imports for {len(reqs)} requests")
    expect_pair("serving_bench_disagg", c, "kv_block_update_quant_pair", c["steps"], n_layers)
    totals["kv_block_update_quant_pair"] += c["kv_block_update_quant_pair"]
    emit(phase="serving_bench", run="disagg", card=card, wall_s=time.perf_counter() - t0,
         requests=len(reqs), kv_imports=imports, launches=c)
    del seen, reqs
    cleanup()
    return dict(totals), passes


#: phase 19f's timed steps a tower [20]; phase 19g's timed calls a probe [20]
STAGE_STEPS = 3
CONV_ITERS = 4


def stage_profile_phase(card: str, device: str = "cuda") -> None:
    """Phase 19f: ``kubeflow_tpu_torch.e2e.stage_profile`` at batch 256, the
    conv7x7 stem and the four stages with BatchNorm in train mode,
    ``STAGE_STEPS`` timed steps a tower: ms, counted GFLOP and TF/s a
    tower (unfused blocks: no fused-block launch)."""
    from kubeflow_tpu_torch.e2e import stage_profile
    from kubeflow_tpu_torch.ops import fused_bottleneck as fb

    fb.reset_launches()
    out = stage_profile.profile(batch=256, steps=STAGE_STEPS, device=device)
    for r in out["rows"]:
        emit(phase="stage_profile", card=card, batch=256, steps=STAGE_STEPS, **r)
    emit(phase="stage_profile", card=card, sum_ms=out["sum_ms"], launches=dict(fb.LAUNCHES))
    rates = [r["ms"] for r in out["rows"]] + [r["tflops"] or 0.0 for r in out["rows"]]
    if len(out["rows"]) != 5 or not all(np.isfinite(rates)) or min(rates) <= 0 \
            or any(fb.LAUNCHES.values()):
        raise AssertionError(f"stage_profile: rows {out['rows']}, launches {fb.LAUNCHES}")
    cleanup()


def conv_experiments_phase(card: str, device: str = "cuda") -> None:
    """Phase 19g: every probe of ``kubeflow_tpu_torch.e2e.conv_experiments``
    at its full shapes, ``CONV_ITERS`` timed calls of ``CHAIN`` steps each:
    TF/s and seconds a chain step. A probe that raises fails the phase."""
    from kubeflow_tpu_torch.e2e import conv_experiments as ce

    rows = ce.run_probes(iters=CONV_ITERS, device=device)
    for name, r in zip(ce.PROBES, rows):
        emit(phase="conv_experiments", card=card, probe=name, iters=CONV_ITERS,
             chain=ce.CHAIN, **r)
    bad = [r for r in rows if r.get("error") or not np.isfinite(r["tflops"])
           or r["tflops"] <= 0]
    if bad:
        raise AssertionError(f"conv_experiments: {bad}")
    cleanup()


#: phase 22a: timed steps a window and timed windows of the ResNet and GPT
#: rows (bench.py: 50 and 3; its warm-up window is as long); the sweeps
#: measure max(4, min(10, n)) ResNet and max(2, min(4, n)) GPT steps a
#: candidate, after a warm-up step
BENCH_STEPS, BENCH_REPEATS = 4, 2
#: phase 22a: the timed windows' last losses, relative to the first's. Each
#: window restarts from one snapshot, so they differ only by cuDNN's
#: non-deterministic weight gradients (phase 20a saw 1.53e-5 in a ResNet-50
#: loss of ~7 before it pinned cuDNN); 4 more steps move the loss by ~0.1
BENCH_WINDOW_LOSS_TOL = 1e-4
#: phase 22a: the HPO row's trials and trials at once (bench.py: 16 and 4)
BENCH_HPO_TRIALS, BENCH_HPO_PARALLEL = 4, 2
#: phase 22a: the multichip row's steps and windows (bench.py: 5 and 3)
BENCH_MC_STEPS, BENCH_MC_REPEATS = 2, 1
#: the keys of bench.py's rows (``_run_resnet``, ``_run_gpt``,
#: ``_run_serving``, ``_run_hpo``, ``_run_multichip``), which the port's
#: rows carry exactly
BENCH_ROW_KEYS = {
    "resnet": {"metric", "value", "unit", "vs_baseline", "images_per_sec_per_chip", "batch",
               "window_mfus", "fused_blocks", "fused_calibration", "autotune",
               "step_breakdown", "peak_hbm_bytes", "attribution", "platform"},
    "gpt": {"metric", "value", "unit", "vs_baseline", "tokens_per_sec_per_chip", "batch", "seq",
            "window_mfus", "scan_blocks", "remat", "fused_loss", "autotune", "step_breakdown",
            "peak_hbm_bytes", "attribution", "platform"},
    "serving": {"metric", "value", "unit", "vs_baseline", "bert_http_p50_ms_b8",
                "bert_http_rows", "decode_rows", "continuous_batching", "ttft_p50", "ttft_p99",
                "queue_wait_p99", "spec_accept_rate", "disagg", "decode_tok_s_heterogeneous",
                "kv_handoff_p99_s", "platform"},
    "hpo": {"metric", "value", "unit", "vs_baseline", "trials", "trials_succeeded",
            "trials_pruned", "elapsed_seconds", "best_accuracy", "platform"},
    "multichip": {"metric", "value", "unit", "vs_baseline", "scaling_efficiency",
                  "tokens_per_sec_1chip", "n_devices", "mesh", "virtual_stages", "gather_mode",
                  "num_micro", "microbatch", "bubble_fraction", "bubble_fraction_gpipe",
                  "comm_bytes_per_step", "loss", "step_breakdown", "peak_hbm_bytes",
                  "attribution", "platform"},
}
#: the prediction phase 22a prints beside the ResNet sweep's choice: the fused
#: step 385.2 ms against 246.9 ms unfused (PERF.md §5; H100 80GB HBM3, 700 W)
AT_PREDICTED = {"fused_blocks": False}
#: phases 22a, train and resnet_train: a row's clocked ``compute`` (host,
#: ending at the synchronize) against CUDA events recorded at its two ends,
#: per clock record (a window, a step) on average
AT_EVENT_TOL = 0.05
#: phases 22a, train and resnet_train: the attribution walk's train-step FLOPs against the row's
#: counted ``flops_per_step``. On meta tensors at the bench shapes the walk
#: is 1.0126x the count for ResNet-50 (3 x the forward against the real
#: backward, which skips the stem's input gradient) and 1.0576x for GPT
#: (the walk's plain attention prices the full L x L dots, the count the
#: causal 3.5 of them a layer)
AT_FLOPS_TOL = {"resnet": 0.03, "gpt": 0.08}


class EventClock:
    """A ``StepClock`` whose ``compute`` phase also records a CUDA event at
    each end: the card's own time over the interval the host clock reads.
    While ``compute`` ends at the loop's synchronize the two agree; a
    ``compute`` that ended at the dispatch would read far less than its
    events (the end event waits behind the step's kernels)."""

    def __new__(cls):
        from contextlib import contextmanager

        from kubeflow_tpu_torch.gpu.profiling import StepClock

        class _Clock(StepClock):
            def __init__(self):
                super().__init__()
                self.events = []

            @contextmanager
            def compute(self):
                start = torch.cuda.Event(enable_timing=True)
                end = torch.cuda.Event(enable_timing=True)
                with super().compute():
                    start.record()
                    yield
                    end.record()
                self.events.append((start, end))

            def event_compute_s(self) -> float:
                torch.cuda.synchronize()
                return sum(a.elapsed_time(b) for a, b in self.events) / 1e3 / len(self.events)

        return _Clock()


class LaunchDeltas:
    """Launches of one kernel family between ``observe`` events: each swept
    candidate's, then the rest of the run's (``take``); the sweep's result
    and the bench's raw ``run`` result."""

    def __init__(self, launches: dict) -> None:
        self.launches = launches
        self.base = dict(launches)
        self.candidates = []
        self.sweep = self.result = None

    def take(self) -> dict:
        now = dict(self.launches)
        out = {k: now[k] - self.base.get(k, 0) for k in now}
        self.base = now
        return out

    def __call__(self, stage: str, info: dict) -> None:
        if stage == "candidate":
            self.candidates.append({**info, "launches": self.take()})
        elif stage == "sweep":
            self.sweep = info["result"]
        elif stage == "run":
            self.result = info["result"]


def check_attribution(label: str, card: str, out: dict, clock, costs, generation: str,
                      phase: str = "bench"):
    """A bench row's ``attribution`` (or ``train()``'s, one record a step)
    against the report rebuilt from the row's clock (the row's rounded
    fractions equal;
    fractions summing to 1 within 1e-6 and the measured phases rebuilding
    the window within 5%, which the clock's ``other`` makes so by
    construction), then against two measurements made apart from it: the
    report's ``compute`` seconds against the CUDA events of ``clock`` (an
    :class:`EventClock`) within ``AT_EVENT_TOL``, and the walk's FLOPs
    (``costs``) against the row's counted ``flops_per_step`` (``out``: the
    bench's raw result) within ``AT_FLOPS_TOL``."""
    from kubeflow_tpu_torch.training.attribution import attribution_report

    report = attribution_report(costs, clock=clock, generation=generation)
    frac = sum(report.fractions.values())
    rebuilt = sum(report.measured.values())
    event_s = clock.event_compute_s()
    walk = sum(m.flops for m in costs)
    flops_ratio = walk / out["flops_per_step"]
    row = out["attribution"]
    emit(phase=phase, row=label, card=card, generation=generation,
         fractions=report.fractions, measured=report.measured,
         step_seconds=report.step_seconds, fraction_sum=frac, rebuilt_s=rebuilt,
         event_compute_s=event_s, walk_flops=walk, loop_flops=out["flops_per_step"],
         walk_over_loop_flops=flops_ratio, coverage=report.coverage(),
         top_unfused=[m.name for m in report.top_sinks(5, fused=False)],
         top_fused=[m.name for m in report.top_sinks(5, fused=True)])
    if "error" in row or row["fractions"] != report.to_dict()["fractions"]:
        raise AssertionError(f"{phase} {label}: attribution row {row}")
    if abs(frac - 1.0) > 1e-6 or abs(rebuilt - report.step_seconds) > 0.05 * report.step_seconds:
        raise AssertionError(f"{phase} {label}: fractions sum {frac}, phases "
                             f"{rebuilt} s against the step's {report.step_seconds} s")
    compute_s = report.measured["compute"]
    if abs(compute_s - event_s) > AT_EVENT_TOL * event_s:
        raise AssertionError(f"{phase} {label}: clocked compute {compute_s} s "
                             f"against the events' {event_s} s")
    if abs(flops_ratio - 1.0) > AT_FLOPS_TOL[label]:
        raise AssertionError(f"{phase} {label}: walk {walk} FLOP against the "
                             f"loop's {out['flops_per_step']} ({flops_ratio:.4f}x)")
    return report


def autotune_attribution_phase(card: str, device: str = "cuda") -> None:
    """Phase 19h: ``e2e.attribution_driver.run(device)`` on the card: its
    four checks (the bench sweeps that were this phase's are 22a's)."""
    from kubeflow_tpu_torch.e2e import attribution_driver
    from kubeflow_tpu_torch.gpu import profiling as prof

    t0 = time.perf_counter()
    report = attribution_driver.run(device=device)
    prof._PROFILE_CLOCKS.pop("train", None)
    emit(phase="autotune_attribution", bench="attribution_driver", card=card, report=report,
         seconds=time.perf_counter() - t0)
    if report.get("ok") is not True:
        raise AssertionError(f"autotune_attribution: driver {report}")


def check_window_losses(name: str, losses: list) -> None:
    """Every timed window restarts from the restored snapshot: the windows'
    last losses agree within ``BENCH_WINDOW_LOSS_TOL`` of the first's (a
    window that went on from the one before would have trained
    ``BENCH_STEPS`` more steps)."""
    gap = max(abs(v - losses[0]) for v in losses) / abs(losses[0])
    if len(losses) != BENCH_REPEATS or not gap <= BENCH_WINDOW_LOSS_TOL:
        raise AssertionError(f"bench {name}: window losses {losses} (relative gap {gap})")


def check_row(name: str, row: dict) -> None:
    """A bench row on the card: no ``error``, bench.py's keys, ``value >
    0``, ``platform`` "gpu"."""
    if (row.get("error") or set(row) != BENCH_ROW_KEYS[name] or not row["value"] > 0
            or row["platform"] != "gpu"):
        raise AssertionError(f"bench {name}: row {row} (keys expected "
                             f"{sorted(BENCH_ROW_KEYS[name])})")


def bench_phase(card: str, serving: dict, device: str = "cuda") -> dict:
    """Phase 22a: the port's ``bench`` rows. (1) ``run_resnet`` at batch 256
    with ``fused_blocks="auto"``: both candidates measured
    (``fused_bottleneck`` 12 and ``fused_transition`` 4 a step of the fused
    one, none of the unfused one), the choice printed beside
    ``AT_PREDICTED``, then the warm-up window and ``BENCH_REPEATS``
    windows of ``BENCH_STEPS`` steps of the choice (its launches a step),
    whose last losses agree (:func:`check_window_losses`); its
    ``attribution`` row held by :func:`check_attribution`; the fused walk at
    224 x 224 covers 16/16 bottlenecks and leaves only the stem and the head
    unfused. (2) ``run_gpt`` at b 8 x 1024 with ``autotune=True``: remat off
    and on priced on meta tensors, remat pruned by price, the other
    measured (24 launches of each flash kernel a step), then the counted
    step and the windows (24 a step); its window losses and ``attribution``
    row held the same way. Both rows set up through ``training/resnet.py``
    and ``training/gpt.py`` ``prepare``, which ``train()`` runs too. (3)
    The serving row from 19e's four passes (``serving``). (4) ``run_hpo``
    at ``BENCH_HPO_TRIALS`` trials, ``BENCH_HPO_PARALLEL`` at once, median
    stopping on; a study this small prunes no trial (nor do 6 or 8 at 2 at
    once on the CPU), so the pruning path is left to the CPU tests. (5)
    ``run_multichip`` on one NCCL rank at JAX's defaults. Each row held by
    :func:`check_row` (the multichip row also by the dry run's
    ``entry.check_timed_row``) and printed, then the summary line. Returns
    the fused-block and flash kernels' launches."""
    from kubeflow_tpu_torch import bench, entry
    from kubeflow_tpu_torch.ops import flash_attention as fa
    from kubeflow_tpu_torch.ops import fused_bottleneck as fb
    from kubeflow_tpu_torch.training import gpt, resnet
    from kubeflow_tpu_torch.training.attribution import (attribute_gpt, attribute_resnet,
                                                         attribution_report)
    from kubeflow_tpu_torch.training.flops import detect_generation

    gen = detect_generation(device)
    totals: Counter = Counter()
    rows, seconds = {}, {}
    windows = BENCH_STEPS * (1 + BENCH_REPEATS)  # the warm-up window and the timed ones

    # (1) ResNet-50
    t0 = time.perf_counter()
    cfg = resnet.bench_config()
    fb.reset_launches()
    deltas = LaunchDeltas(fb.LAUNCHES)
    clock = EventClock()
    row = bench.run_resnet(timed_steps=BENCH_STEPS, repeats=BENCH_REPEATS, clock=clock,
                           observe=deltas, device=device)
    final = deltas.take()
    emit(phase="bench", row="resnet", card=card, timed_steps=BENCH_STEPS,
         repeats=BENCH_REPEATS, result=row)
    check_row("resnet", row)
    out = deltas.result
    for c in deltas.candidates:
        n = c["steps"] if c["knobs"]["fused_blocks"] else 0
        want = {"fused_bottleneck": 12 * n, "fused_transition": 4 * n}
        emit(phase="bench", row="resnet", card=card, candidate=c["knobs"],
             measured_ms=c["seconds"] * 1e3, steps=c["steps"], launches=c["launches"])
        if c["launches"] != want:
            raise AssertionError(f"bench resnet {c['knobs']}: launches {c['launches']}, "
                                 f"expected {want}")
        totals.update(c["launches"])
    n = windows if out["fused_blocks"] else 0
    want = {"fused_bottleneck": 12 * n, "fused_transition": 4 * n}
    emit(phase="bench", row="resnet", card=card, batch=out["batch"],
         chosen=row["autotune"]["chosen"], predicted=AT_PREDICTED,
         as_predicted=row["autotune"]["chosen"] == AT_PREDICTED, sweep=deltas.sweep.to_dict(),
         step_ms=out["step_seconds"] * 1e3, window_losses=out["window_losses"],
         flops_per_step=out["flops_per_step"], peak_mem_gib=out["peak_hbm_bytes"] / 2**30,
         launches=final)
    if len(deltas.candidates) != 2 or row["autotune"]["measured"] != 2 or final != want:
        raise AssertionError(f"bench resnet: {len(deltas.candidates)} candidates measured, "
                             f"run launches {final} (expected {want})")
    check_window_losses("resnet", out["window_losses"])
    totals.update(final)
    shape = dict(batch=cfg.batch, image=cfg.image, num_classes=cfg.num_classes, stem=cfg.stem,
                 stage_sizes=tuple(cfg.stage_sizes), num_filters=cfg.num_filters,
                 generation=gen)
    check_attribution("resnet", card, out, clock,
                      attribute_resnet(fused_blocks=out["fused_blocks"], **shape), gen)
    fused_walk = attribution_report(attribute_resnet(fused_blocks=True, **shape),
                                    clock=clock, generation=gen)
    unfused = {m.name for m in fused_walk.top_sinks(6, fused=False)}
    emit(phase="bench", row="resnet_fused_walk", card=card, coverage=fused_walk.coverage(),
         top_unfused=sorted(unfused), fractions=fused_walk.fractions)
    if fused_walk.coverage() != {"fused": 16, "total": 16} \
            or unfused != {"stem", "classifier_head"}:
        raise AssertionError(f"bench: fused walk coverage {fused_walk.coverage()}, "
                             f"unfused {unfused}")
    rows["resnet"] = row
    del out, deltas
    cleanup()
    seconds["resnet"] = time.perf_counter() - t0

    # (2) GPT
    t0 = time.perf_counter()
    gcfg = gpt.bench_config(TRAIN_SEQ)
    fa.reset_launches()
    deltas = LaunchDeltas(fa.LAUNCHES)
    clock = EventClock()
    row = bench.run_gpt(batch=TRAIN_BATCH, seq=TRAIN_SEQ, timed_steps=BENCH_STEPS,
                        repeats=BENCH_REPEATS, clock=clock, observe=deltas, device=device)
    final = deltas.take()
    emit(phase="bench", row="gpt", card=card, timed_steps=BENCH_STEPS, repeats=BENCH_REPEATS,
         result=row)
    check_row("gpt", row)
    out = deltas.result
    table = deltas.sweep.to_dict()
    for c in deltas.candidates:
        fwd = gcfg.n_layers * c["steps"] * (2 if c["knobs"]["remat"] else 1)
        want = {"flash_fwd": fwd, "flash_bwd_dq": gcfg.n_layers * c["steps"],
                "flash_bwd_dkv": gcfg.n_layers * c["steps"]}
        emit(phase="bench", row="gpt", card=card, candidate=c["knobs"],
             measured_ms=c["seconds"] * 1e3, steps=c["steps"], launches=c["launches"])
        if c["launches"] != want:
            raise AssertionError(f"bench gpt {c['knobs']}: launches {c['launches']}, "
                                 f"expected {want}")
        totals.update(c["launches"])
    fwd = gcfg.n_layers * (windows * (2 if out["remat"] else 1) + 1)  # + the counted step
    bwd = gcfg.n_layers * (windows + 1)
    want = {"flash_fwd": fwd, "flash_bwd_dq": bwd, "flash_bwd_dkv": bwd}
    remat = next(c for c in table["candidates"] if c["knobs"]["remat"])
    emit(phase="bench", row="gpt", card=card, batch=TRAIN_BATCH, seq=TRAIN_SEQ,
         chosen=row["autotune"]["chosen"], sweep=table, remat_pruned=remat["pruned"],
         step_ms=out["step_seconds"] * 1e3, window_losses=out["window_losses"],
         flops_per_step=out["flops_per_step"], peak_mem_gib=out["peak_hbm_bytes"] / 2**30,
         launches=final)
    a = row["autotune"]
    if (a["swept"] != 2 or a["measured"] != 1 or a["pruned"] != 1 or a["errors"]
            or final != want):
        raise AssertionError(f"bench gpt: sweep {a}, run launches {final} (expected {want})")
    check_window_losses("gpt", out["window_losses"])
    totals.update(final)
    gcfg = dataclasses.replace(gcfg, scan_blocks=out["scan_blocks"], remat=out["remat"])
    check_attribution("gpt", card, out, clock, attribute_gpt(
        gcfg, batch=TRAIN_BATCH, seq=TRAIN_SEQ, generation=gen), gen)
    rows["gpt"] = row
    del out, deltas
    cleanup()
    seconds["gpt"] = time.perf_counter() - t0

    # (3) the serving row from 19e's passes
    rows["serving"] = bench.serving_row(serving["bert"], serving["decode"],
                                        serving["continuous"], serving["disagg"], "gpu")
    emit(phase="bench", row="serving", card=card, depth="19e", result=rows["serving"])
    check_row("serving", rows["serving"])

    # (4) the HPO study
    t0 = time.perf_counter()
    rows["hpo"] = bench.run_hpo(trials=BENCH_HPO_TRIALS, parallel=BENCH_HPO_PARALLEL,
                                device=device)
    seconds["hpo"] = time.perf_counter() - t0
    emit(phase="bench", row="hpo", card=card, result=rows["hpo"])
    check_row("hpo", rows["hpo"])
    h = rows["hpo"]
    if h["trials_succeeded"] + h["trials_pruned"] != BENCH_HPO_TRIALS \
            or not 0.0 <= h["best_accuracy"] <= 1.0:
        raise AssertionError(f"bench hpo: {h}")
    cleanup()

    # (5) the composite step on one NCCL rank, held also by the dry run's
    # assertions on its timed row (the same code at the dry run's shapes runs
    # in the CPU tests)
    t0 = time.perf_counter()
    rows["multichip"] = bench.run_multichip(1, timed_steps=BENCH_MC_STEPS,
                                            repeats=BENCH_MC_REPEATS, device=device)
    seconds["multichip"] = time.perf_counter() - t0
    emit(phase="bench", row="multichip", card=card, result=rows["multichip"])
    check_row("multichip", entry.check_timed_row(rows["multichip"]))
    m = rows["multichip"]
    if m["n_devices"] != 1 or not m["scaling_efficiency"] > 0 or not np.isfinite(m["loss"]):
        raise AssertionError(f"bench multichip: {m}")

    emit(phase="bench", row="summary", card=card, seconds=seconds,
         summary=bench.summary_row(rows, "gpu"))
    return dict(totals)


# -- phases 19i-19k: the MoE GPT, ring attention's blocks, a one-rank NCCL world ----

#: phase 19i: GPT-small with JAX's MoE fields; the training run (batch, seq, steps)
MOE_EXPERTS, MOE_K = 8, 2
MOE_TRAIN = (8, 256, 3)
#: phase 19j: the bench GPT's attention (h 16, d 64, bf16, causal) over a ring
#: of 4 blocks of 1024 (L 4096), batch 2
RING_B, RING_H, RING_N, RING_BLOCK, RING_D = 2, 16, 4, 1024, 64
#: phase 19k: microbatches x microbatch of the composite step, steps a run
DIST_MICRO, DIST_MB, DIST_STEPS = 4, 8, 3


def moe_config():
    from kubeflow_tpu_torch.models.gpt import GptConfig

    return dataclasses.replace(GptConfig.small(), num_experts=MOE_EXPERTS, moe_k=MOE_K)


class AdmitGate:
    """Holds the engine's worker once it has taken the first arrival off its
    queue, until ``release`` is set: what is submitted meanwhile is drained
    in the same pass, so the whole burst is admitted as one wave."""

    def __init__(self, engine):
        self.engine, self.real = engine, engine._enqueue_pendings
        self.release = threading.Event()
        engine._enqueue_pendings = self

    def __call__(self, item):
        if not self.release.wait(timeout=300):
            raise RuntimeError("admission gate never released")
        self.engine._enqueue_pendings = self.real
        return self.real(item)


def moe_serve(card: str, label: str, cfg, params, prompts, kernel: bool):
    """The 8 prompts through one paged engine (8 slots), admitted as one
    wave (``AdmitGate``): a MoE block's capacity is shared by every row of
    a call, idle and padded rows included, so both runs must batch the same
    requests together. Returns (tokens per prompt, launches and decode
    steps of the run)."""
    from kubeflow_tpu_torch.runtime.metrics import METRICS
    from kubeflow_tpu_torch.serving.continuous import ContinuousBatcher

    eng = ContinuousBatcher(cfg, params, slots=8, paged=True, kv_kernel=kernel, device="cuda")
    try:
        METRICS.reset()
        w = LaunchWindow()
        gate = AdmitGate(eng)
        t0 = time.perf_counter()
        reqs = [eng.submit(p, MAX_NEW) for p in prompts]
        gate.release.set()
        toks = [list(r.result(timeout=600)) for r in reqs]
        wall = time.perf_counter() - t0
        counts = w.take()
    finally:
        eng.close()
    if any(len(t) != MAX_NEW or min(t) < 0 or max(t) >= cfg.vocab_size for t in toks):
        raise AssertionError(f"{label}: malformed tokens {[len(t) for t in toks]}")
    emit(phase="moe", run=label, card=card, requests=len(prompts), wall_s=wall,
         tokens_per_s=len(prompts) * MAX_NEW / wall, decode_steps=counts["steps"],
         launches=counts)
    return toks, counts


def moe_phase(card: str, prompts) -> dict:
    """Phase 19i: GPT-small with 8 experts, top-2 (seeded weights), served
    paged by the engine with the 8 prompts through the kernels and through
    the plain writes: the same greedy tokens, ``kv_block_update_pair`` 12 a
    decode step (no launch on the plain run); then 3 AdamW steps of
    ``GptLM(decode=False)`` at b 8 x 256 through the flash kernels (12
    launches of each a step and the counted reference step) and through
    the plain attention: finite losses within 0.02 at step 1 and 0.05 over
    the run. Returns the kernels' launches of the kernel runs."""
    from kubeflow_tpu_torch.models.gpt import causal_plain_attention, init_params
    from kubeflow_tpu_torch.ops import flash_attention as fa
    from kubeflow_tpu_torch.training.gpt import train

    cfg = moe_config()
    params = init_params(cfg, seed=0, device="cuda")
    got, c = moe_serve(card, "serve_kernel", cfg, params, prompts, kernel=True)
    expect_pair("moe_serve_kernel", c, "kv_block_update_pair", c["steps"], cfg.n_layers)
    launches = Counter(kv_block_update_pair=c["kv_block_update_pair"])
    want, c = moe_serve(card, "serve_plain", cfg, params, prompts, kernel=False)
    expect_none("moe_serve_plain", c)
    if got != want:
        diff = sum(a != b for a, b in zip(got, want))
        raise AssertionError(f"moe: kernel-path tokens differ from plain-path tokens in "
                             f"{diff} of {len(got)} requests")
    del params
    cleanup()

    b, seq, steps = MOE_TRAIN
    runs = {}
    for label, attn in (("kernel", None), ("plain", causal_plain_attention)):
        cleanup()
        torch.cuda.reset_peak_memory_stats()
        fa.reset_launches()
        res = train(cfg, batch=b, seq=seq, steps=steps, seed=0, device="cuda",
                    **({} if attn is None else {"attention_fn": attn}))
        c = dict(fa.LAUNCHES)
        want_n = cfg.n_layers * (steps + 1) if attn is None else 0
        if any(n != want_n for n in c.values()) or not all(np.isfinite(res["losses"])):
            raise AssertionError(f"moe train {label}: launches {c} (want {want_n} each), "
                                 f"losses {res['losses']}")
        if attn is None:
            launches.update(c)
        runs[label] = res
        emit(phase="moe", run=f"train_{label}", card=card, batch=b, seq=seq,
             n_params=res["n_params"], losses=res["losses"], step_ms=res["step_ms"],
             tokens_per_s=res["tokens_per_step"] / float(np.median(res["step_ms"][1:])) * 1e3,
             peak_mem_gib=res["peak_hbm_bytes"] / 2**30, launches=c)
    lk, lp = runs["kernel"]["losses"], runs["plain"]["losses"]
    first, worst = abs(lk[0] - lp[0]), max(abs(x - y) for x, y in zip(lk, lp))
    if not (first <= 0.02 and worst <= 0.05):
        raise AssertionError(f"moe train: kernel vs plain losses: step 1 {first}, worst {worst}")
    emit(phase="moe", card=card, experts=MOE_EXPERTS, k=MOE_K, requests_equal=len(got),
         step1_loss_diff=first, max_loss_diff=worst)
    cleanup()
    return dict(launches)


def nccl_world() -> None:
    """A one-rank NCCL process group on this card (once)."""
    import socket

    import torch.distributed as dist

    if dist.is_initialized():
        return
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        port = s.getsockname()[1]
    dist.init_process_group("nccl", init_method=f"tcp://127.0.0.1:{port}", rank=0,
                            world_size=1)


def rel_err(a: torch.Tensor, b: torch.Tensor) -> float:
    return max_abs_err(a, b) / max(float(b.float().abs().max()), 1e-30)


def ring_phase(card: str) -> dict:
    """Phase 19j: ring attention's block steps at ring size 4 in one
    process (no collective): each query block's 4 flash forwards at its
    global offsets merged by log-sum-exp in f32, then the backward from the
    global out (f32, as the merge leaves it) and lse with dk/dv summed per
    block, against ``flash_attention`` over the whole sequence (within 2%
    of the largest value, relative: out in f32 against the whole call's f32
    out and rounded to bf16 against its bf16 out, the gradients against its
    backward from its f32 out); both times. Then ``ring_attention`` over a
    one-rank NCCL group against ``flash_attention``: the same bits on out
    (one block's f32 out through the merge, rounded once), and on the
    gradients against ``flash_attention_bwd`` from the same f32 out (the
    ring's backward takes delta from the unrounded out). Returns the flash
    launches of the checked runs (16 + 1 of each)."""
    from kubeflow_tpu_torch.ops import flash_attention as fa
    from kubeflow_tpu_torch.parallel.mesh import MeshConfig, make_mesh
    from kubeflow_tpu_torch.parallel.ring_attention import (ring_attention, ring_backward,
                                                             ring_forward)

    b, h, n, lb, d = RING_B, RING_H, RING_N, RING_BLOCK, RING_D
    L, scale = n * lb, d ** -0.5
    gen = torch.Generator(device="cuda").manual_seed(0)
    q, k, v, dout = (torch.randn(b, L, h, d, device="cuda", generator=gen)
                     .to(torch.bfloat16) for _ in range(4))
    qb, kb, vb, db = ([x.contiguous() for x in t.split(lb, dim=1)] for t in (q, k, v, dout))

    def blocks_for(idx):
        return ((kb[(idx - i) % n], vb[(idx - i) % n]) for i in range(n))

    def forward():
        return [ring_forward(qb[i], blocks_for(i), i, n, causal=True, scale=scale)
                for i in range(n)]

    def backward(fw):
        dk = [torch.zeros(x.shape, device="cuda") for x in kb]
        dv = [torch.zeros(x.shape, device="cuda") for x in vb]

        def fold(src, dk_i, dv_i):
            dk[src] += dk_i.float()
            dv[src] += dv_i.float()

        dq = [ring_backward(qb[i], fw[i][0], fw[i][1], db[i], blocks_for(i), i, n,
                            causal=True, scale=scale, on_block=fold) for i in range(n)]
        return torch.cat(dq, 1), torch.cat(dk, 1), torch.cat(dv, 1)

    fa.reset_launches()
    fw = forward()
    grads = backward(fw)
    torch.cuda.synchronize()
    launches = dict(fa.LAUNCHES)
    if launches != {"flash_fwd": n * n, "flash_bwd_dq": n * n, "flash_bwd_dkv": n * n}:
        raise AssertionError(f"ring: block-step launches {launches}, expected {n * n} each")
    out = torch.cat([o for o, _ in fw], 1)
    if out.dtype != torch.float32:
        raise AssertionError(f"ring: ring_forward returned {out.dtype}, not the f32 merge")
    ref_out, ref_lse = fa.flash_attention_fwd(q, k, v, causal=True, scale=scale,
                                              out_dtype=torch.float32)
    ref = fa.flash_attention_bwd(q, k, v, ref_out, ref_lse, dout, causal=True, scale=scale)
    errs = {"out": rel_err(out, ref_out),
            "out_bf16": rel_err(out.to(torch.bfloat16), ref_out.to(torch.bfloat16))}
    errs.update({name: rel_err(g, r) for name, g, r in zip(("dq", "dk", "dv"), grads, ref)})
    if not all(e <= 2e-2 for e in errs.values()):
        raise AssertionError(f"ring: block steps vs flash_attention over the whole "
                             f"sequence, relative errors {errs}")
    times = {"ring_fwd_ms": cuda_ms(forward, iters=5, warmup=1),
             "ring_bwd_ms": cuda_ms(lambda: backward(fw), iters=5, warmup=1),
             "whole_fwd_ms": cuda_ms(lambda: fa.flash_attention_fwd(
                 q, k, v, causal=True, scale=scale), iters=5, warmup=1),
             "whole_bwd_ms": cuda_ms(lambda: fa.flash_attention_bwd(
                 q, k, v, ref_out, ref_lse, dout, causal=True, scale=scale), iters=5, warmup=1)}
    emit(phase="ring", card=card, batch=b, heads=h, head_dim=d, ring=n, block=lb, seq=L,
         causal=True, dtype="bf16", rel_err=errs, launches=launches, **times)
    del fw, grads, ref, ref_out, ref_lse
    cleanup()

    # the same module over a one-rank NCCL group: a ring of one
    nccl_world()
    mesh = make_mesh(MeshConfig(), device="cuda")
    fa.reset_launches()
    qr, kr, vr = (x.detach().clone().requires_grad_(True) for x in (q, k, v))
    o = ring_attention(qr, kr, vr, mesh, causal=True)
    o.backward(dout)
    one = dict(fa.LAUNCHES)
    of = fa.flash_attention(q, k, v, causal=True)
    # the ring's backward starts from its f32 out: flash_attention_bwd from
    # the same f32 out and lse
    of32, lse32 = fa.flash_attention_fwd(q, k, v, causal=True, scale=scale,
                                         out_dtype=torch.float32)
    grads32 = fa.flash_attention_bwd(q, k, v, of32, lse32, dout, causal=True, scale=scale)
    same = {name: torch.equal(a, c) for name, a, c in (
        ("out", o, of), ("dq", qr.grad, grads32[0]), ("dk", kr.grad, grads32[1]),
        ("dv", vr.grad, grads32[2]))}
    if not all(same.values()) or one != {"flash_fwd": 1, "flash_bwd_dq": 1, "flash_bwd_dkv": 1}:
        raise AssertionError(f"ring over one NCCL rank vs flash_attention: equal {same}, "
                             f"launches {one}")
    # against flash_attention's own backward (from its bf16 out), printed
    qf, kf, vf = (x.detach().clone().requires_grad_(True) for x in (q, k, v))
    fa.flash_attention(qf, kf, vf, causal=True).backward(dout)
    vs_bf16_out = {name: rel_err(a, c) for name, a, c in (
        ("dq", qr.grad, qf.grad), ("dk", kr.grad, kf.grad), ("dv", vr.grad, vf.grad))}
    emit(phase="ring", run="nccl_one_rank", card=card, seq=L, equal=same, launches=one,
         grads_rel_err_vs_backward_from_bf16_out=vs_bf16_out)
    for name in launches:
        launches[name] += one[name]
    cleanup()
    return launches


def tiny_paths_phase(card: str) -> dict:
    """Phase 21a: the entry points that reach the flash kernels at head_dim
    16 (BERT-tiny's and GPT-tiny's 4 heads of 16, the quick GPT's 2 of 16),
    each with the counts reset just before it and read just after.
    Returns the flash launches of the four paths, summed."""
    import torch.distributed as dist

    from kubeflow_tpu_torch import entry
    from kubeflow_tpu_torch.models.bert import BertConfig, BertForMaskedLM
    from kubeflow_tpu_torch.models.gpt import GptConfig, causal_plain_attention
    from kubeflow_tpu_torch.ops import flash_attention as fa
    from kubeflow_tpu_torch.parallel.ring_attention import full_attention
    from kubeflow_tpu_torch.serving.server import bert_served_model
    from kubeflow_tpu_torch.training.autotune import autotune_gpt_quick
    from kubeflow_tpu_torch.training.gpt import train

    total = {name: 0 for name in fa.LAUNCHES}

    def counted(label, want, run):
        fa.reset_launches()
        result = run()
        torch.cuda.synchronize()
        got = dict(fa.LAUNCHES)
        expect = want(result) if callable(want) else want
        if got != expect:
            raise AssertionError(f"tiny_paths {label}: flash launches {got}, expected {expect}")
        for name, n in got.items():
            total[name] += n
        return result, got

    # GPT-tiny trained through the kernels (bf16: the tensor-core kernels at
    # d 16) and through the plain attention, from the same seeded weights
    cfg = GptConfig.tiny()
    b, seq, steps = 4, cfg.max_seq, 3
    each = cfg.n_layers * (steps + 1)  # the counted reference step, then the steps
    runs = {}
    for label, kw in (("kernel", {}), ("plain", {"attention_fn": causal_plain_attention})):
        want = {n: each for n in total} if not kw else {n: 0 for n in total}
        res, got = counted(f"gpt_tiny_{label}", want, lambda: train(
            cfg, batch=b, seq=seq, steps=steps, seed=0, device="cuda", **kw))
        runs[label] = res["losses"]
        if not all(np.isfinite(res["losses"])):
            raise AssertionError(f"tiny_paths gpt_tiny {label}: losses {res['losses']}")
    lk, lp = runs["kernel"], runs["plain"]
    first, worst = abs(lk[0] - lp[0]), max(abs(x - y) for x, y in zip(lk, lp))
    emit(phase="tiny_paths", path="gpt_tiny_train", card=card, heads=cfg.n_heads,
         head_dim=cfg.d_model // cfg.n_heads, batch=b, seq=seq, steps=steps,
         losses_kernel=lk, losses_plain=lp, step1_loss_diff=first, max_loss_diff=worst,
         launches_each=each)
    if not (first <= 0.02 and worst <= 0.05):
        raise AssertionError(f"tiny_paths gpt_tiny: kernel vs plain losses {lk} / {lp}")

    # BERT-tiny served: predict through auto_attention against full_attention
    served = bert_served_model(tiny=True, device="cuda")
    bert_cfg = BertConfig.tiny()
    rows = np.random.default_rng(0).integers(0, bert_cfg.vocab_size, (4, 48)).tolist()
    preds, got = counted("bert_tiny_served", {"flash_fwd": bert_cfg.num_layers,
                                              "flash_bwd_dq": 0, "flash_bwd_dkv": 0},
                         lambda: served.predict(rows))
    full = BertForMaskedLM.bind(bert_cfg, served.params, attention_fn=full_attention)
    with torch.no_grad():
        want_logits = full(torch.as_tensor(rows, dtype=torch.int32, device="cuda"))
    logits = torch.tensor(preds, device="cuda")
    err = max_abs_err(logits, want_logits)
    agree = float((logits.argmax(-1) == want_logits.argmax(-1)).float().mean())
    emit(phase="tiny_paths", path="bert_tiny_served", card=card, heads=bert_cfg.num_heads,
         head_dim=bert_cfg.head_dim, rows=len(rows), seq=len(rows[0]), max_abs_err=err,
         argmax_agreement=agree, launches=got)
    if tuple(logits.shape) != tuple(want_logits.shape) or not err <= 0.1:
        raise AssertionError(f"tiny_paths bert_tiny_served: logits {tuple(logits.shape)} "
                             f"vs {tuple(want_logits.shape)}, max err {err}")
    served.close()

    # the quick GPT sweep: its measured candidates' steps through the kernels
    q_steps, q_layers = 2, 2

    def per_measured(result):
        n = q_layers * (1 + q_steps) * sum(c.measured_seconds is not None
                                           for c in result.candidates)
        return {name: n for name in total}

    result, got = counted("autotune_gpt_quick", per_measured,
                          lambda: autotune_gpt_quick(steps=q_steps, device="cuda"))
    emit(phase="tiny_paths", path="autotune_gpt_quick", card=card, chosen=result.chosen,
         row=result.to_row(), launches=got)
    if not any(got.values()):
        raise AssertionError("tiny_paths autotune_gpt_quick: no flash launch")

    # the dry run's BERT phase on a fresh one-rank NCCL world (19k's is gone)
    nccl_world()
    summary, got = counted("dryrun_bert", {n: bert_cfg.num_layers for n in total},
                           lambda: entry._bert_phase(1, torch.device("cuda")))
    emit(phase="tiny_paths", path="dryrun_bert", card=card, summary=summary, launches=got)
    if (summary["heads"], summary["head_dim"]) != (4, 16):
        raise AssertionError(f"tiny_paths dryrun_bert: {summary}")
    dist.destroy_process_group()
    cleanup()
    return total


def dist1_phase(card: str) -> None:
    """Phase 19k: on the one-rank NCCL world, the composite dp x fsdp x tp x
    pp step (every axis 1: the collectives still run, on NCCL) at JAX's
    ``CompositeConfig`` defaults in each gather mode, and the FSDP step at
    JAX's ``FsdpConfig`` defaults in both, 3 SGD steps each from the same
    seeded weights: finite, falling losses; ``eager`` and ``overlap`` the
    same bits, losses and parameters, in both steps; ``amortized`` within
    1e-5 of ``eager`` (its gradients are summed in another order). Step ms
    by the host clock around a synchronized step."""
    import torch.distributed as dist

    from kubeflow_tpu_torch.parallel import composite as comp
    from kubeflow_tpu_torch.parallel.collectives import gather_global
    from kubeflow_tpu_torch.parallel.mesh import MeshConfig, make_mesh
    from kubeflow_tpu_torch.training import fsdp

    nccl_world()

    def run(step, params, ids):
        losses, ms = [], []
        for _ in range(DIST_STEPS):
            t0 = time.perf_counter()
            params, loss = step(params, ids)
            torch.cuda.synchronize()
            ms.append((time.perf_counter() - t0) * 1e3)
            losses.append(float(loss))
        if not (all(np.isfinite(losses)) and losses[-1] < losses[0]):
            raise AssertionError(f"dist1: losses {losses}")
        return losses, ms, params

    rng = np.random.default_rng(1)
    cfg = comp.CompositeConfig()
    mesh = make_mesh(MeshConfig(), device="cuda")
    ids = comp.local_ids(rng.integers(0, cfg.vocab_size, (DIST_MICRO, DIST_MB, cfg.seq)), mesh)
    runs = {}
    for mode in comp.GATHER_MODES:
        losses, ms, params = run(comp.make_train_step(cfg, mesh, gather_mode=mode),
                                 comp.init_params(cfg, mesh, seed=0), ids)
        runs[mode] = (losses, comp.canonical_params(params, mesh))
        emit(phase="dist1", step="composite", gather_mode=mode, card=card, losses=losses,
             step_ms=ms)
    same = runs["eager"][0] == runs["overlap"][0] and all(
        np.array_equal(a, c) for a, c in zip(_canon_leaves(runs["eager"][1]),
                                            _canon_leaves(runs["overlap"][1])))
    near = max(float(np.abs(a - c).max()) for a, c in zip(_canon_leaves(runs["eager"][1]),
                                                            _canon_leaves(runs["amortized"][1])))
    if not same or near > 1e-5:
        raise AssertionError(f"dist1 composite: eager == overlap {same}, amortized off "
                             f"eager by {near}")

    fcfg = fsdp.FsdpConfig()
    fmesh = fsdp.fsdp_mesh(device="cuda")
    fids = fsdp.local_batch(rng.integers(0, fcfg.vocab_size, (8, fcfg.seq)), fmesh)
    fruns = {}
    for mode in fsdp.FSDP_GATHER_MODES:
        losses, ms, params = run(fsdp.make_fsdp_train_step(fcfg, fmesh, gather_mode=mode),
                                 fsdp.init_fsdp_params(fcfg, fmesh, seed=0), fids)
        whole = [gather_global(params["embed"], fmesh, fsdp.EMBED_SPEC)] + [
            gather_global(params["blocks"][k], fmesh, fsdp.BLOCK_SPECS[k])
            for k in sorted(params["blocks"])]
        fruns[mode] = (losses, [t.cpu().numpy() for t in whole])
        emit(phase="dist1", step="fsdp", gather_mode=mode, card=card, losses=losses,
             step_ms=ms)
    fsame = fruns["eager"][0] == fruns["overlap"][0] and all(
        np.array_equal(a, c) for a, c in zip(fruns["eager"][1], fruns["overlap"][1]))
    if not fsame:
        raise AssertionError("dist1 fsdp: eager and overlap differ")
    emit(phase="dist1", card=card, world=dist.get_world_size(), backend=dist.get_backend(),
         composite_eager_equals_overlap=same, composite_amortized_max_diff=near,
         fsdp_eager_equals_overlap=fsame)
    dist.destroy_process_group()
    cleanup()


#: phase 20a's steps a run; phase 20b's steps, periodic checkpoint, tolerances
MESH_STEPS = 4
ELASTIC_STEPS, ELASTIC_CKPT_EVERY = 12, 4
#: 20a: the sharded step against the mesh-less one from the same weights
#: (the same program on one rank, up to the loss's sum-over-count and the
#: gathers' copies): about 20x the largest gaps read on an H100 (losses
#: 4.8e-7 and parameters 1.45e-6 over five runs; a leaf's gap over its own
#: update 1.04e-3, one run), read with cuDNN free to pick a
#: non-deterministic algorithm, which once moved a run's own loss by
#: 1.53e-5; the phase now holds cuDNN to deterministic ones; 20b: JAX's
#: driver tolerance against an uninterrupted run
MESH_LOSS_TOL, MESH_PARAM_TOL, MESH_UPDATE_TOL = 1e-5, 2e-5, 2e-2
ELASTIC_LOSS_TOL = 1e-3


def classifier_mesh_phase(card: str) -> dict:
    """Phase 20a: on a one-rank NCCL world, the bench ResNet-50 (batch 256
    of 224², s2d stem, fused blocks, SGD-momentum) through
    ``ClassifierTask(mesh, FSDP_RULES)`` (every parameter a shard by JAX's
    rules, gathered each step by ``all_gather``; the optimizer on the
    shards), ``MESH_STEPS`` steps, and the same steps of the mesh-less task
    from the same seeded weights: finite losses, ``fused_bottleneck`` 12 and
    ``fused_transition`` 4 launches a step in both, losses and parameters
    within ``MESH_LOSS_TOL`` / ``MESH_PARAM_TOL`` of the mesh-less run, and
    each leaf's update within ``MESH_UPDATE_TOL`` of the mesh-less one's,
    relative to it (none missing); whether they are the same bits; step ms
    and images/s of each run. cuDNN's wgrad may sum in any order from one
    call to the next, so every run is held to its deterministic algorithms
    (``cudnn.deterministic``, no ``cudnn.benchmark``; put back after) and
    the mesh-less task runs twice: the second run must repeat the first
    bit for bit, so the gaps above are the mesh's own. Returns the mesh
    run's kernel launches."""
    import torch.distributed as dist

    from kubeflow_tpu_torch.ops import fused_bottleneck as fb
    from kubeflow_tpu_torch.parallel.mesh import MeshConfig, make_mesh
    from kubeflow_tpu_torch.parallel.sharding import FSDP_RULES
    from kubeflow_tpu_torch.training.classifier import ClassifierTask
    from kubeflow_tpu_torch.training.resnet import (bench_config, make_batch, make_model,
                                                    make_task)

    nccl_world()
    cfg = bench_config()
    images, labels = make_batch(cfg, 0, "cuda")
    mesh = make_mesh(MeshConfig(), device="cuda")
    runs = {}
    saved = torch.backends.cudnn.deterministic, torch.backends.cudnn.benchmark
    torch.backends.cudnn.deterministic, torch.backends.cudnn.benchmark = True, False
    try:
        for label in ("meshless", "mesh", "meshless_again"):
            cleanup()
            model = make_model(cfg, seed=0, device="cuda")
            if label == "meshless":
                start = {n: p.detach().float().cpu() for n, p in model.named_parameters()}
            base = make_task(cfg, model)
            task = base if label != "mesh" else ClassifierTask(
                model, base.optimizer, mesh=mesh, rules=FSDP_RULES)
            state = task.init()
            x, y = task.local_batch(images), task.local_batch(labels)
            fb.reset_launches()
            losses, ms = [], []
            for _ in range(MESH_STEPS):
                t0 = time.perf_counter()
                state, metrics = task.train_step(state, x, y)
                torch.cuda.synchronize()
                ms.append((time.perf_counter() - t0) * 1e3)
                losses.append(float(metrics["loss"]))
            launches = dict(fb.LAUNCHES)
            want = {"fused_bottleneck": 12 * MESH_STEPS, "fused_transition": 4 * MESH_STEPS}
            if launches != want or not all(np.isfinite(losses)):
                raise AssertionError(f"classifier_mesh {label}: launches {launches} (expected "
                                     f"{want}), losses {losses}")
            steady = float(np.median(ms[1:]))
            runs[label] = {"losses": losses, "launches": launches,
                           "params": {n: p.float().cpu() for n, p in
                                      task.canonical_params(state).items()}}
            emit(phase="classifier_mesh", path=label, card=card, batch=cfg.batch,
                 image=cfg.image, mesh=dict(mesh.shape) if label == "mesh" else None,
                 rules="FSDP_RULES" if label == "mesh" else None, losses=losses, step_ms=ms,
                 step_ms_median=steady, images_per_s=cfg.batch / steady * 1e3,
                 launches=launches)
            del model, base, task, state
    finally:
        torch.backends.cudnn.deterministic, torch.backends.cudnn.benchmark = saved
    a, b, c = runs["mesh"], runs["meshless"], runs["meshless_again"]
    if c["losses"] != b["losses"] or not all(torch.equal(c["params"][n], b["params"][n])
                                             for n in b["params"]):
        raise AssertionError(f"classifier_mesh: the mesh-less run did not repeat its own bits "
                             f"under deterministic cuDNN: losses {b['losses']} then "
                             f"{c['losses']}")
    loss_diff = max(abs(u - v) for u, v in zip(a["losses"], b["losses"]))
    param_diff = max(float((a["params"][n] - b["params"][n]).abs().max()) for n in b["params"])
    same = a["losses"] == b["losses"] and all(torch.equal(a["params"][n], b["params"][n])
                                              for n in b["params"])
    # each leaf's update against the mesh-less run's: a dropped or
    # mis-summed one shows even where the update is small
    moved = {n: float((b["params"][n] - start[n]).abs().max()) for n in b["params"]}
    dropped = [n for n in b["params"] if moved[n] > 0
               and float((a["params"][n] - start[n]).abs().max()) == 0]
    gaps = {n: float((a["params"][n] - b["params"][n]).abs().max()) / moved[n]
            for n in b["params"] if moved[n] > 0}
    worst = max(gaps, key=gaps.get)
    if (loss_diff > MESH_LOSS_TOL or param_diff > MESH_PARAM_TOL or dropped
            or gaps[worst] > MESH_UPDATE_TOL):
        raise AssertionError(f"classifier_mesh: mesh vs mesh-less losses off by {loss_diff}, "
                             f"parameters by {param_diff}, {worst}'s update by {gaps[worst]} "
                             f"of itself; updates missing: {dropped}")
    emit(phase="classifier_mesh", card=card, world=dist.get_world_size(),
         backend=dist.get_backend(), max_loss_diff=loss_diff, max_param_diff=param_diff,
         loss_tol=MESH_LOSS_TOL, param_tol=MESH_PARAM_TOL, same_bits=same,
         max_update_gap=gaps[worst], max_update_gap_leaf=worst, update_tol=MESH_UPDATE_TOL,
         smallest_update=min(moved.values()), leaves=len(moved),
         cudnn_deterministic=True, meshless_repeats_bits=True)
    dist.destroy_process_group()
    del runs, start
    cleanup()
    return a["launches"]


def elastic1_phase(card: str) -> None:
    """Phase 20b: on a one-rank NCCL world, ``ElasticTrainer`` with
    ``CompositeWorkload`` (JAX's ``CompositeConfig`` defaults), a
    ``StepClock``, a ``WorkerBeacon`` and a ``GoodputLedger``, on offers of
    the one card scripted on the drivers' in-memory cluster: (pp 1, V 1)
    drained after its third step → (pp 1, V 2) lost at a step ≡ 1 mod
    ``ELASTIC_CKPT_EVERY`` → (pp 1, V 1) to the end. Checks: completed; one
    preemption survived and 2 steps replayed, as scripted; the loss curve
    within ``ELASTIC_LOSS_TOL`` of an uninterrupted run on the card; goodput
    fractions summing to exactly 1.0 and reconstructing the wallclock within
    5%. Prints the composite step ms and the decomposition."""
    import torch.distributed as dist

    from kubeflow_tpu_torch.e2e.elastic_cluster import (NAMESPACE, PodClient, add_nodes,
                                                        evict, place_gang, preempt_gang)
    from kubeflow_tpu_torch.gpu.profiling import StepClock
    from kubeflow_tpu_torch.monitoring.goodput import GoodputLedger
    from kubeflow_tpu_torch.training.checkpoint import Checkpointer
    from kubeflow_tpu_torch.training.elastic import (CompositeWorkload, ElasticTrainer,
                                                     PreemptionHandler, SliceOffer)
    from kubeflow_tpu_torch.training.heartbeat import WorkerBeacon, clear_beacons

    nccl_world()
    client = PodClient()
    add_nodes(client, ["gpu-node-0"], 1)
    shapes = [(1, 1), (1, 2), (1, 1)]
    gangs = []

    def provider(attempt):
        if gangs:
            evict(client, gangs[-1])
        if attempt >= len(shapes):
            return None
        gangs.append(place_gang(client, f"elastic1-g{attempt}", 1, 1, grace=20.0))
        pp, v = shapes[attempt]
        return SliceOffer(devices=[0], pp=pp, virtual_stages=v, pods=gangs[-1],
                          namespace=NAMESPACE)

    class Scripted(CompositeWorkload):
        def run_step(self, state, step):
            state, loss = super().run_step(state, step)
            attempt, local = len(gangs) - 1, state.setdefault("local", 0)
            if attempt == 0 and local == 2:
                preempt_gang(client, gangs[-1], 20.0)
            elif attempt == 1 and local >= 1 and step % ELASTIC_CKPT_EVERY == 1:
                evict(client, gangs[-1])  # lost: no drain signal
            state["local"] = local + 1
            return state, loss

    clear_beacons()
    clock = StepClock()
    ledger = GoodputLedger("elastic1")
    ckpt_dir = tempfile.mkdtemp(prefix="elastic1-")
    try:
        trainer = ElasticTrainer(
            Scripted(clock=clock, beacon=WorkerBeacon("elastic1-0"), device="cuda"),
            Checkpointer(ckpt_dir), provider, ELASTIC_STEPS,
            checkpoint_every=ELASTIC_CKPT_EVERY, goodput=ledger,
            handler_factory=lambda offer: PreemptionHandler(client, NAMESPACE, offer.pods,
                                                            poll_interval=0.0))
        t0 = time.perf_counter()
        report = trainer.run()
        wall = time.perf_counter() - t0
    finally:
        shutil.rmtree(ckpt_dir, ignore_errors=True)
    ref = CompositeWorkload(device="cuda")
    state = ref.init(SliceOffer(devices=[0]))
    ref_losses, ref_ms = {}, []
    for s in range(ELASTIC_STEPS):
        t = time.perf_counter()
        state, ref_losses[s] = ref.run_step(state, s)
        ref_ms.append((time.perf_counter() - t) * 1e3)
    snap = ledger.snapshot()
    outcomes = [i["outcome"] for i in report.incarnations]
    replayed = [i["goodput"]["replaySteps"] for i in report.incarnations]
    worst = max(abs(report.losses[s] - ref_losses[s]) for s in ref_losses)
    step_ms = [r["total"] * 1e3 for r in clock.steps]
    emit(phase="elastic1", card=card, world=dist.get_world_size(), backend=dist.get_backend(),
         incarnations=[{k: v for k, v in i.items() if k != "goodput"}
                       for i in report.incarnations],
         max_loss_diff=worst, loss_tol=ELASTIC_LOSS_TOL, losses=report.losses,
         step_ms=step_ms, step_ms_median=float(np.median(step_ms)),
         uninterrupted_step_ms_median=float(np.median(ref_ms[1:])), wall_s=wall,
         goodput_fraction=snap["goodputFraction"], fractions=snap["fractions"],
         badput_seconds=snap["badputSeconds"],
         reconstruction_error=snap["reconstructionError"])
    if not (report.completed and outcomes == ["preempted", "lost", "completed"]
            and report.preemptions_survived == 1 and replayed == [0, 0, 2]
            and [i["offer"]["virtualStages"] for i in report.incarnations] == [1, 2, 1]):
        raise AssertionError(f"elastic1: incarnations {report.incarnations}")
    if worst > ELASTIC_LOSS_TOL or not all(np.isfinite(list(report.losses.values()))):
        raise AssertionError(f"elastic1: losses off the uninterrupted run by {worst}")
    if sum(snap["fractions"].values()) != 1.0 or snap["reconstructionError"] > 0.05:
        raise AssertionError(f"elastic1: goodput fractions {snap['fractions']}, "
                             f"reconstruction error {snap['reconstructionError']}")
    clear_beacons()
    dist.destroy_process_group()
    cleanup()


def _canon_leaves(canon):
    yield canon["embed"]
    for k in sorted(canon["stages"]):
        yield canon["stages"][k]


# -- phases 16-19: the device-evidence path ------------------------------------------

STREAM_SOURCE = "kubeflow_tpu_torch/ops/csrc/stream_copy.cu"
STREAM_REPLACES = {
    "stream_copy": "e2e/fused_bottleneck_probe.py:95 (kern in _pallas_copy, pallas_call :100)",
    "stream_copy_dma":
        "e2e/fused_bottleneck_probe.py:107 (kern in _manual_dma_copy, pallas_call :143)",
}
#: the probe's stage-1 activations: N, HW, CIN
PROBE_N, PROBE_HW, PROBE_C = 256, 56, 256


def refused(call, label: str) -> None:
    try:
        call()
    except ValueError:
        return
    raise AssertionError(f"stream_kernels: {label} was not refused")


def stream_kernels_phase(card: str):
    """Both streaming-copy kernels at the probe's shapes against the plain
    version, bit for bit, twice; the refused shapes; per call the kernel's
    time (back-to-back calls, and alone on the device), the plain version's,
    one ``torch.mul`` by SCALE (the library call; the plain version is that
    same call) and the bytes bound: x read once, the output written once;
    the device ms of the design the kernel replaced, launched through the
    sweep's entry (not counted), and the launch shapes of the kernel and of
    ``torch.mul``."""
    from kubeflow_tpu_torch.e2e import stream_copy_sweep as sweep
    from kubeflow_tpu_torch.ops import stream_copy as sc

    g = torch.Generator(device="cuda").manual_seed(0)
    x4 = (torch.randn(PROBE_N, PROBE_HW, PROBE_HW, PROBE_C, generator=g, device="cuda")
          * 0.3).to(torch.bfloat16)
    flat = x4.view(-1, PROBE_C)
    cases = {
        "stream_copy_2d": ("stream_copy", flat, lambda: sc.stream_copy(flat, (3136, PROBE_C))),
        "stream_copy_4d": ("stream_copy", x4,
                           lambda: sc.stream_copy(x4, (1, PROBE_HW, PROBE_HW, PROBE_C))),
        "stream_copy_dma": ("stream_copy_dma", flat, lambda: sc.stream_copy_dma(flat, 4096)),
    }
    results = {}
    for label, (name, x, call) in cases.items():
        sc.reset_launches()
        a, b = call(), call()
        want = sc.stream_copy_plain(x)
        torch.cuda.synchronize()
        if sc.LAUNCHES[name] != 2:
            raise AssertionError(f"stream_kernels {label}: launches {sc.LAUNCHES}")
        if not (torch.equal(a, b) and torch.equal(a, want)):
            raise AssertionError(f"stream_kernels {label}: differs from the plain version "
                                 f"or between runs (max {max_abs_err(a, want)})")
        del a, b, want
        nbytes = 2.0 * x.numel() * x.element_size()
        bound_ms = nbytes / HBM_BYTES_PER_S * 1e3
        ms = cuda_ms(call, iters=20, warmup=3)
        dev_ms = kernel_device_ms(call, name + "_kernel", iters=10)
        plain_ms = cuda_ms(lambda: sc.stream_copy_plain(x), iters=20, warmup=3)
        library_ms = cuda_ms(lambda: torch.mul(x, sc.SCALE), iters=20, warmup=3)
        lib_dev_ms, lib_names = library_device_ms(lambda: torch.mul(x, sc.SCALE), iters=10)
        lib_names = [n[:90] for n in lib_names]
        parent = sweep.PARENT[name]
        parent_out = torch.empty_like(x)
        parent_dev_ms = kernel_device_ms(lambda: sweep.launch(name, parent, x, parent_out),
                                         f"{name}_{parent['design']}_kernel", iters=10)
        del parent_out
        emit(phase="stream_kernels", kernel=label, card=card, shape=list(x.shape),
             bit_equal=True, deterministic=True, kernel_ms=ms, kernel_device_ms=dev_ms,
             plain_ms=plain_ms, library_ms=library_ms, library="torch.mul(x, SCALE)",
             library_device_ms=lib_dev_ms, library_kernels=lib_names,
             device_over_library_device=dev_ms / lib_dev_ms,
             bound_ms=bound_ms, bound_by="bytes", bytes=nbytes,
             gbps=nbytes / ms / 1e6, device_gbps=nbytes / dev_ms / 1e6,
             bound_share=bound_ms / dev_ms, parent_design=parent["design"],
             parent_device_ms=parent_dev_ms, device_over_parent=dev_ms / parent_dev_ms,
             launch_shape=sweep.launch_shapes(call),
             library_launch_shape=sweep.launch_shapes(lambda: torch.mul(x, sc.SCALE)))
        if label != "stream_copy_4d":
            results[name] = dict(name=name, route="cuda", source=STREAM_SOURCE,
                                 replaces=STREAM_REPLACES[name], max_abs_err=0.0, ms=ms,
                                 plain_ms=plain_ms, bound_ms=bound_ms, bound_by="bytes",
                                 library_ms=library_ms)
    small = flat[:8192]
    refused(lambda: sc.stream_copy(flat, (3000, PROBE_C)), "a block not dividing dim 0")
    refused(lambda: sc.stream_copy(flat, (3136, 128)), "a block narrower than dim 1")
    refused(lambda: sc.stream_copy(x4, (1, PROBE_HW, 28, PROBE_C)), "a 4-D block not whole")
    refused(lambda: sc.stream_copy(small.float(), (8192, PROBE_C)), "an f32 tensor")
    refused(lambda: sc.stream_copy(small.t(), (PROBE_C, 8192)), "a transposed view")
    refused(lambda: sc.stream_copy(small.view(-1)[1:8193], (8192,)), "a misaligned view")
    refused(lambda: sc.stream_copy(small[:3, :3].contiguous(), (3, 3)), "an odd size")
    refused(lambda: sc.stream_copy_dma(flat[:5000], 4096), "m not a multiple of bm")
    refused(lambda: sc.stream_copy_dma(flat[:4096], 4096), "a single tile")
    refused(lambda: sc.stream_copy_dma(x4, 4096), "a 4-D tensor")
    emit(phase="stream_kernels", card=card, refused=10)
    del x4, flat, small
    gc.collect()
    torch.cuda.empty_cache()
    return results


PROBE_CHAIN = 4


def probe_phase(card: str) -> dict:
    """The fused-block probe at its full shapes, in-process (its six rows
    print one line each). Returns the streaming kernels' launches of the
    run, which must both be above 0."""
    from kubeflow_tpu_torch.e2e import fused_bottleneck_probe as fbp
    from kubeflow_tpu_torch.ops import stream_copy as sc

    sc.reset_launches()
    if fbp.main(["--chain", str(PROBE_CHAIN)]) != 0:
        raise AssertionError("probe: main() failed")
    launches = dict(sc.LAUNCHES)
    emit(phase="probe", card=card, chain=PROBE_CHAIN, launches=launches)
    if not all(n > 0 for n in launches.values()):
        raise AssertionError(f"probe: a streaming kernel was never launched: {launches}")
    gc.collect()
    torch.cuda.empty_cache()
    return launches


def ceiling_phase(card: str) -> None:
    """The device-ceiling probe's rows, each beside the catalog's peak, at
    the probe's own iteration counts (~5 s)."""
    from kubeflow_tpu_torch.e2e import ceiling

    out = ceiling.sweep()
    for r in out["kernels"]:
        emit(phase="ceiling", card=card, **r, of_peak=r["tflops"] * 1e12 / BF16_FLOPS_PER_S)
    emit(phase="ceiling", card=card, **out["hbm"],
         of_peak=out["hbm"]["gbs"] * 1e9 / HBM_BYTES_PER_S)
    for r in ceiling.flash_sweep():
        emit(phase="ceiling", card=card, **r, of_peak=r["tflops"] * 1e12 / BF16_FLOPS_PER_S)
    rates = [r["tflops"] for r in out["kernels"]] + [out["hbm"]["gbs"]]
    if not all(np.isfinite(rates)) or min(rates) <= 0:
        raise AssertionError(f"ceiling: rates {rates}")
    emit(phase="ceiling", card=card, ceiling_tflops=out["ceiling_tflops"],
         peak_tflops=BF16_FLOPS_PER_S / 1e12, hbm_gbs=out["hbm"]["gbs"],
         peak_hbm_gbs=HBM_BYTES_PER_S / 1e9)
    gc.collect()
    torch.cuda.empty_cache()


PROFILE_STEPS = 4


def step_profiles_phase(card: str) -> None:
    """The two step decompositions at their full shapes, fewer steps."""
    from kubeflow_tpu_torch.e2e import gpt_profile, profile_step

    out = profile_step.profile(batch=256, steps=PROFILE_STEPS)
    ms = {k: v * 1e3 for k, v in out["seconds"].items()}
    delta_ms = {k: v * 1e3 for k, v in profile_step.deltas(out["seconds"]).items()}
    emit(phase="step_profiles", probe="profile_step", card=card, batch=256,
         steps=PROFILE_STEPS, ms=ms, delta_ms=delta_ms)
    gc.collect()
    torch.cuda.empty_cache()
    rows = gpt_profile.profile(batch=8, seq=1024, steps=PROFILE_STEPS)
    emit(phase="step_profiles", probe="gpt_profile", card=card, batch=8, seq=1024,
         steps=PROFILE_STEPS, rows=rows,
         sum_ms=sum(r.get("x24_ms", r["ms"]) for r in rows))
    if not all(np.isfinite(list(ms.values()) + [r["ms"] for r in rows])):
        raise AssertionError("step_profiles: a time is not finite")
    gc.collect()
    torch.cuda.empty_cache()


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: CUDA is not available", file=sys.stderr)
        return 2
    sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
    from kubeflow_tpu_torch.ops import _build
    from kubeflow_tpu_torch.training import flops

    global BF16_FLOPS_PER_S, HBM_BYTES_PER_S
    card = smi()
    print(card, flush=True)
    generation = flops.detect_generation()
    BF16_FLOPS_PER_S = flops.peak_flops_per_chip(generation)
    HBM_BYTES_PER_S = flops.peak_hbm_bandwidth(generation)
    t0 = time.perf_counter()
    _build.load_all()
    emit(phase="build", card=card, torch=torch.__version__, cuda=torch.version.cuda,
         build_s=time.perf_counter() - t0, generation=generation,
         peak_bf16_flops_per_s=BF16_FLOPS_PER_S, peak_hbm_bytes_per_s=HBM_BYTES_PER_S)

    seconds = {}

    def timed(name, phase):
        t = time.perf_counter()
        result = phase(card)
        seconds[name] = time.perf_counter() - t
        return result

    try:
        kernels = timed("kernels", kernel_phase)
        launches, prompts, short_tokens, serve_stats = timed("serve+contig+int8", serve_phases)
        timed("ref", ref_phase)
        timed("profile", profile_phase)
        kernels.update(timed("flash", flash_phase))
        timed("train_ref", train_ref_phase)
        launches.update(timed("train", train_phase))
        timed("train_profile", train_profile_phase)
        kernels.update(timed("resnet_kernels", resnet_kernels_phase))
        timed("resnet_ref", resnet_ref_phase)
        launches.update(timed("resnet_train", resnet_train_phase))
        timed("resnet_profile", resnet_profile_phase)
        kernels.update(timed("stream_kernels", stream_kernels_phase))
        launches.update(timed("probe", probe_phase))
        timed("ceiling", ceiling_phase)
        timed("step_profiles", step_profiles_phase)
        timed("spec_write", spec_write_phase)
        for name, n in timed("resnet_data", resnet_data_phase).items():
            launches[name] += n
        timed("mnist_trial", mnist_trial_phase)
        for name, n in timed("profile_clock", profile_clock_phase).items():
            launches[name] += n
        sb_launches, serving_rows = timed("serving_bench", serving_bench_phase)
        for name, n in sb_launches.items():
            launches[name] += n
        timed("stage_profile", stage_profile_phase)
        timed("conv_experiments", conv_experiments_phase)
        for name, n in timed("bench", lambda c: bench_phase(c, serving_rows)).items():
            launches[name] += n
        timed("autotune_attribution", autotune_attribution_phase)
        # after every phase that reads the profiler: these start threads and
        # servers, and read no profiler window
        timed("serve_chunked+obs", lambda c: serve_chunked_phase(c, prompts, short_tokens))
        timed("bert_serve", bert_phase)
        spec_runs = timed("spec_serve", lambda c: spec_serve_phase(
            c, prompts, short_tokens, serve_stats))
        launches["kv_row_update_pair"] += sum(spec_runs.values())
        for name, n in timed("distill", distill_phase).items():
            launches[name] += n
        for name, n in timed("disagg", lambda c: disagg_phase(c, prompts)).items():
            launches[name] += n
        for name, n in timed("fleet", lambda c: fleet_phase(c, prompts, short_tokens)).items():
            launches[name] += n
        for name, n in timed("serving_drivers",
                             lambda c: serving_drivers_phase(c, prompts, short_tokens)).items():
            launches[name] += n
        for name, n in timed("monitoring", monitoring_phase).items():
            launches[name] += n
        for name, n in timed("moe", lambda c: moe_phase(c, prompts)).items():
            launches[name] += n
        for name, n in timed("ring", ring_phase).items():
            launches[name] += n
        timed("dist1", dist1_phase)
        for name, n in timed("tiny_paths", tiny_paths_phase).items():
            launches[name] += n
        for name, n in timed("classifier_mesh", classifier_mesh_phase).items():
            launches[name] += n
        timed("elastic1", elastic1_phase)
        # last: its ~10^6 launches (the decode chunks of in_model) come after
        # every profiler window
        timed("kv_probe", kv_probe_phase)
        emit(phase="timing", card=card, seconds=seconds)
    finally:  # the windows are printed whether a phase failed or not
        emit(phase="profiler_windows", card=card, windows=WINDOWS)
    for name, n in launches.items():
        kernels[name]["launches"] = n

    order = ("kv_row_update_pair", "kv_block_update_pair", "kv_block_update_quant_pair",
             "flash_fwd", "flash_bwd_dq", "flash_bwd_dkv",
             "fused_bottleneck", "fused_transition", "stream_copy", "stream_copy_dma")
    emit(kernels=[kernels[k] for k in order])
    print(smi(), flush=True)
    emit(ok=True, device={"platform": "gpu", "kind": torch.cuda.get_device_name(0),
                          "count": torch.cuda.device_count()})
    return 0


def serve_phases(card: str):
    """Phases 3-5: GPT-small served in three KV layouts, each held against
    its plain writes. Each run's pair kernel launches once per layer and
    decode step, and its one-array wrapper never. The 600-token prompt goes
    through chunked prefill in the paged run and through the static
    ``generate()`` path (``prefill_chunk=0``) in the contiguous one. Returns
    each KV kernel's launches in its layout's run, the 8 prompts and each
    layout's kernel-path tokens and run stats (``serve``)."""
    from kubeflow_tpu_torch.models.gpt import GptConfig

    n_layers = GptConfig.small().n_layers
    rng = np.random.default_rng(0)
    prompts = [rng.integers(0, 32000, n).astype(np.int32) for n in PROMPT_LENS]
    long_prompt = rng.integers(0, 32000, LONG_PROMPT).astype(np.int32)

    def expect(label, counts, name, steps, *never):
        if steps == 0 or counts[name] != n_layers * steps or any(counts[n] for n in never):
            raise AssertionError(f"{label}: {counts} over {steps} decode steps; expected "
                                 f"{n_layers} {name} a step and no {never}")

    # default: the kernels
    bf16_k, c, st = serve(prompts, card, "serve_paged_kernel", long_prompt=long_prompt)
    expect("serve_paged_kernel", c, "kv_block_update_pair", st["steps"], "kv_block_update")
    stats = {"paged": st}
    launches = {"kv_block_update_pair": c["kv_block_update_pair"]}
    bf16_p, c, _ = serve(prompts, card, "serve_paged_plain", kv_kernel=False)
    if any(c.values()):
        raise AssertionError(f"kv_kernel=False launched kernels: {c}")
    if bf16_k != bf16_p:
        raise AssertionError("paged bf16: kernel-path tokens differ from plain-path tokens")

    contig, c, st = serve(prompts, card, "serve_contiguous_kernel", long_prompt=long_prompt,
                          paged=False, prefill_chunk=0)
    expect("serve_contiguous_kernel", c, "kv_row_update_pair", st["steps"], "kv_row_update",
           "kv_block_update_pair")
    stats["contiguous"] = st
    launches["kv_row_update_pair"] = c["kv_row_update_pair"]
    if contig != bf16_k:
        raise AssertionError("contiguous tokens differ from paged tokens")

    int8_k, c, st = serve(prompts, card, "serve_int8_kernel", kv_dtype="int8")
    expect("serve_int8_kernel", c, "kv_block_update_quant_pair", st["steps"],
           "kv_block_update_quant")
    stats["int8"] = st
    launches["kv_block_update_quant_pair"] = c["kv_block_update_quant_pair"]
    int8_p, _, _ = serve(prompts, card, "serve_int8_plain", kv_kernel=False, kv_dtype="int8")
    if int8_k != int8_p:
        raise AssertionError("int8: kernel-path tokens differ from plain-path tokens")
    agree = np.mean([a == b for x, y in zip(int8_k, bf16_k) for a, b in zip(x, y)])
    emit(phase="int8_vs_bf16", card=card, token_agreement=float(agree))
    return launches, prompts, {"paged": bf16_k, "contiguous": contig, "int8": int8_k}, stats


if __name__ == "__main__":
    sys.exit(main())
