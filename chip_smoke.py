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
             on, the default chunk 256: ``prewarm(16)``, then the 8 prompts
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
             sequences of 16 + 48 tokens) on a GPT-small teacher: 15
             ``flash_fwd``, 3 ``flash_bwd_dq`` and 3 ``flash_bwd_dkv``
             launches a step, the last step's KL below the first's, the
             distilled draft's ``measure_accept_rate`` at least the
             self-draft's; steps/s;
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
             replicas, then again: tokens held to phase 3's (``near_tie``),
             the second pass routed by prefix (8 hits),
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
             d 64, b 16 at L 128 and b 8 at L 100) and bf16_dots; the split: at d 32, 64 and 128, out,
             dq, dk and dv differ from the f32 answer rounded to bf16 in at
             most 2% of elements (p and ds as hi + lo), and in more under
             bf16_dots (hi alone); each kernel run twice and compared bit
             for bit; per-call times beside the bound, the plain versions
             and PyTorch's scaled_dot_product_attention (event time, and
             the device time of every kernel it launches: achieved TF/s,
             device ms over SDPA's device ms); the port's whole backward
             (``flash_bwd_whole``: delta, dq, dk/dv) against SDPA's
             backward alone, on the device, and a check that the bf16
             backward ran the tensor-core dq kernel;
9. train_ref — a tiny f32 GPT: loss and every gradient through the kernels
             on the card against the plain path on the CPU (atol 1e-4);
10. train  — the bench's GPT-2-medium-class config at full width (b 8,
             L 1024), the counted reference step then 8 AdamW steps through
             the kernels (24 launches of each per step), then the same
             through the plain attention (no launch): finite losses, step-1
             losses within 0.02, trajectories within 0.05, falling loss; step
             ms, tokens/s, peak memory, the counted and the bench's analytic
             FLOPs, mfu and the step breakdown;
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
             analytic FLOPs, mfu and the step breakdown;
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
20. kv_probe — ``kubeflow_tpu_torch.e2e.kv_update_probe``: the KV writes
             alone (contiguous and paged), the host split of a write's
             call, the decode chunk per token with the writes plain and
             through the kernels. It runs last: no profiler window follows
             its launches.

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
distillation's flash launches, the fleet replicas' KV writes): that line's count is then a sum over
several runs, and each path's own count is on its run's line. The fused-block
kernels' entries in the kernels line sum their per-call times over the blocks of one training step (2, 3, 5
and 2 identity blocks; one of each stage head); their ``max_abs_err`` is
the largest over the shapes. Every device time read from torch.profiler
comes from a window that kept the records it is read from: a window that
lost some (a launch call with no kernel record) is taken again, and the
line ``profiler_windows`` before the kernels line lists every window's
launch calls and lost records. Every phase runs on every call;
the last line is ``{"ok": true, "device": {...}}``.
"""

from __future__ import annotations

import dataclasses
import gc
import json
import os
import subprocess
import sys
import threading
import time
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


def hold_to_generate(label: str, cfg, params, prompt, toks, card: str,
                     exact: bool = False) -> dict:
    """``toks`` (a served request's generated tokens) against the port's
    ``generate()`` on the same weights. Equal passes; with ``exact`` (the
    static route, which is ``generate()`` itself) nothing else does. Where a
    chunked prefill's tokens differ (bf16 sums in another order than
    generate()'s one prefill), the first differing step is found and
    generate()'s own logits there are read, step by step as it ran: the
    request passes only if their top-2 gap is under ``NEAR_TIE``."""
    from kubeflow_tpu_torch.models.gpt import generate

    want = generate(cfg, params, prompt[None], MAX_NEW, device="cuda")[0, len(prompt):].tolist()
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
                             device="cuda", seed=0, **kw)
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


def serve_chunked(card: str, layout: str, prompts, short_want, **kw) -> None:
    """GPT-small behind ModelServer in one KV layout, kernels on, the default
    chunk (256): ``prewarm(16)``, then the 8 prompts and one of
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
                             device="cuda", seed=0, **kw)
    server = ModelServer().add(model)
    httpd = server.serve(0)
    try:
        torch.cuda.reset_peak_memory_stats()
        eng = model.engine()
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
    observability routes are read on the paged bf16 server."""
    for layout, kw in (("paged", {}), ("contiguous", dict(paged=False)),
                       ("int8", dict(kv_dtype="int8"))):
        serve_chunked(card, layout, prompts, short_tokens[layout], **kw)


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
    from kubeflow_tpu_torch.models.gpt import GptConfig, init_params

    cfg = GptConfig.small()
    params = None
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
            params = params or init_params(cfg, seed=0, device="cuda")
            differ = sum(not near_tie(label, cfg, params, p, toks, want, card)["equal"]
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
    3-layer draft: the flash launches of each step (``flash_fwd`` 12 + 3,
    ``flash_bwd_dq`` and ``flash_bwd_dkv`` 3), the last step's KL below the
    first's, and ``measure_accept_rate`` of the distilled draft at least the
    self-draft's; steps/s. Returns the flash kernels' launches."""
    from kubeflow_tpu_torch.models.gpt import GptConfig, init_params
    from kubeflow_tpu_torch.ops import flash_attention as fa
    from kubeflow_tpu_torch.training import distill

    cfg = GptConfig.small()
    params = init_params(cfg, seed=0, device="cuda")
    dcfg = distill.draft_config(cfg)
    self_accept = distill.measure_accept_rate(cfg, params, dcfg,
                                              distill.init_from_target(dcfg, params))
    curve, stamps = [], []

    def on_step(step, kl):
        curve.append(kl)
        stamps.append(time.perf_counter())

    fa.reset_launches()
    t0 = time.perf_counter()
    _, draft = distill.distill_draft(cfg, params, on_step=on_step)
    wall = time.perf_counter() - t0
    counts = dict(fa.LAUNCHES)
    steps = len(curve)
    want = {"flash_fwd": (cfg.n_layers + dcfg.n_layers) * steps,
            "flash_bwd_dq": dcfg.n_layers * steps, "flash_bwd_dkv": dcfg.n_layers * steps}
    if counts != want:
        raise AssertionError(f"distill: flash launches {counts} over {steps} steps; "
                             f"expected {want}")
    if not all(np.isfinite(curve)) or not curve[-1] < curve[0]:
        raise AssertionError(f"distill: KL {curve[0]} -> {curve[-1]} did not fall")
    accept = distill.measure_accept_rate(cfg, params, dcfg, draft)
    emit(phase="distill", card=card, steps=steps, draft_layers=dcfg.n_layers,
         kl_first=curve[0], kl_last=curve[-1], wall_s=wall,
         steps_per_s=(steps - 1) / (stamps[-1] - stamps[0]),
         accept_rate_self_draft=self_accept, accept_rate_distilled=accept,
         flash_launches=counts, peak_mem_gib=torch.cuda.max_memory_allocated() / 2**30)
    if accept < self_accept:
        raise AssertionError(f"distill: the distilled draft accepts {accept}, below the "
                             f"self-draft's {self_accept}")
    return counts


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
    from kubeflow_tpu_torch.models.gpt import GptConfig, init_params
    from kubeflow_tpu_torch.ops import kv_cache as kc
    from kubeflow_tpu_torch.runtime.metrics import METRICS
    from kubeflow_tpu_torch.serving.continuous import ContinuousBatcher

    cfg = GptConfig.small()
    params = init_params(cfg, seed=0, device="cuda")
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
    both replicas), then the same 8 again at once; tokens held to the phase
    3 paged run,
    the second pass routed by prefix (8 hits), ``kv_block_update_pair`` 12
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

    def cleanup():
        gc.collect()
        torch.cuda.empty_cache()

    # (a) two replicas behind the HTTP server, the 8 prompts twice
    model = dataclasses.replace(
        gpt_served_model(name="gpt", tiny=False, max_new_tokens=MAX_NEW, device="cuda",
                         seed=0, replicas=2), max_replicas=3)
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
        second = generated("fleet_http", prompts, post_all(httpd.port, prompts, "fleet_http"),
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
    if second != first:
        raise AssertionError("fleet_http: the second pass's tokens differ from the first's")
    if hits < len(prompts):
        raise AssertionError(f"fleet_http: the second pass made {hits} prefix hits, "
                             f"expected {len(prompts)}")
    expect_pair("fleet_http", counts, "kv_block_update_pair", steps, cfg.n_layers)
    ids = {r["id"] for r in snap["replicas"]}
    if ids != {"gpt-0", "gpt-1"} or snap["max_replicas"] != 3:
        raise AssertionError(f"fleet_http: /debug/fleet shows {ids}, max {snap['max_replicas']}")
    ttft_p50 = float(np.median(ttft1))
    emit(phase="fleet_http", card=card, replicas=2, requests=2 * len(prompts),
         requests_by_replica=dict(split), equal_to_single_engine=len(prompts) - differ,
         near_tie_differences=differ, prefix_hits_second_pass=hits,
         routed=snap["router"]["routed"], wall_s=[wall1, wall2],
         tokens_per_s=len(prompts) * MAX_NEW / wall1,
         tokens_per_s_second_pass=len(prompts) * MAX_NEW / wall2, ttft_ms_p50=ttft_p50,
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
    from kubeflow_tpu_torch.models.gpt import GptConfig, init_params

    cfg = GptConfig.small()
    params = init_params(cfg, seed=0, device="cuda")
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


def kv_probe_phase(card: str) -> None:
    """The KV-write probe (``e2e/kv_update_probe.py``): the writes alone,
    the host split of a write's call, and the decode chunk per token with
    the writes plain and through the kernels."""
    from kubeflow_tpu_torch.e2e import kv_update_probe as probe

    iso = probe.isolated()
    emit(phase="kv_probe", card=card, isolated_ms=iso)
    emit(phase="kv_probe", card=card, host_split_us=probe.host_split())
    model = probe.in_model()
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
    for dd in (32, 64, 128):
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
    through the plain attention from the same weights. Returns the flash
    kernels' launches of the kernel run."""
    from kubeflow_tpu_torch.models.gpt import causal_plain_attention
    from kubeflow_tpu_torch.ops import flash_attention as fa
    from kubeflow_tpu_torch.training.gpt import bench_config, train

    cfg = bench_config(TRAIN_SEQ)
    runs = {}
    for label, attn in (("kernel", None), ("plain", causal_plain_attention)):
        gc.collect()
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
        kw = {} if attn is None else {"attention_fn": attn}
        fa.reset_launches()
        res = train(cfg, batch=TRAIN_BATCH, seq=TRAIN_SEQ, steps=TRAIN_STEPS, seed=0,
                    device="cuda", **kw)
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
    different function, timed only). Returns the kernels' launches of the
    kernel run."""
    from kubeflow_tpu_torch.ops import fused_bottleneck as fb
    from kubeflow_tpu_torch.training.resnet import bench_config, train

    cfg = bench_config()
    runs = {}
    for label, kw, steps in (("kernel", {}, RESNET_STEPS),
                             ("plain", {"plain_kernels": True}, RESNET_STEPS),
                             ("unfused", {"fused_blocks": False}, 4)):
        gc.collect()
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
        fb.reset_launches()
        res = train(cfg, steps=steps, seed=0, device="cuda", **kw)
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


PROFILE_STEPS = 8


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
