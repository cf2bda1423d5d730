"""Chip smoke test of the PyTorch/CUDA port (``kubeflow_tpu_torch``).

Run from the repository root on a machine with one NVIDIA H100:

    python3 chip_smoke.py

Phases (any failure exits non-zero; nothing is caught and skipped):

1. build   — the card's name and power limit, torch/CUDA versions, and the
             build of every CUDA kernel from ``kubeflow_tpu_torch/ops/csrc``
             (one nvcc per source, all at once);
2. kernels — each KV-cache kernel at GPT-small serving shapes (8 slots,
             12 heads x 64, 2048 positions, 16-row blocks), with
             out-of-range cursors and a trash-table entry, held bit for bit
             (``torch.equal``) against its plain PyTorch version on the
             card; per-call times of kernel (back-to-back calls, and the kernel
             alone on the device), plain version and one PyTorch
             ``index_put_`` beside the bytes bound;
3. serve   — GPT-small (seeded random weights) behind ``ModelServer`` on
             port 0, paged bf16 arena, 8 slots: 8 concurrent greedy HTTP
             requests, prompts of 16-256 tokens, 32 new tokens each, once
             through the kernels and once through the plain writes; the
             tokens must be identical and ``kv_block_update`` must launch;
4. contig  — the same requests with the contiguous cache through
             ``kv_row_update``: tokens identical to phase 3's;
5. int8    — the same requests with the int8 arena through
             ``kv_block_update_quant``: tokens identical to the int8 plain
             run; agreement with the bf16 tokens is printed;
6. ref     — a tiny f32 model's prefill logits and greedy tokens on the
             card against the same model on the CPU;
7. profile — GPT-small's decode step alone: host ms per step and the
             device-busy share with the top kernels (torch.profiler);
8. flash   — the three flash-attention kernels at the training path's
             shapes (b 8, h 16, L 1024, d 64, causal, bf16) against their
             plain versions (atol 2e-2 on out/dq/dk/dv, 1e-3 on lse), at f32
             shapes (b 2, h 2, L 256, d 32 and 64; atol 1e-4), non-causal,
             lq != lk, q_offset = lk, k_offset = 10 lk (every row masked:
             zeros, lse -1e30) and bf16_dots; each kernel run twice and
             compared bit for bit; per-call times beside the bound, the
             plain versions and PyTorch's scaled_dot_product_attention;
9. train_ref — a tiny f32 GPT: loss and every gradient through the kernels
             on the card against the plain path on the CPU (atol 1e-4);
10. train  — the bench's GPT-2-medium-class config at full width (b 8,
             L 1024), 8 AdamW steps through the kernels (24 launches of each
             per step), then the same 8 steps through the plain attention
             (no launch): finite losses, step-1 losses within 0.02,
             trajectories within 0.05, falling loss; step ms, tokens/s,
             peak memory and mfu (the bench's FLOP count over 989 TF/s);
11. train_profile — host ms of unprofiled train steps, then one step under
             torch.profiler: device-busy share, top kernels, the flash
             kernels' share of the step (every one of their launches seen).

The launch counts reported per kernel come from its main-path phase (the
serving phases for the KV writes, ``train`` for flash attention): they are
reset just before the run and read just after. Every phase runs on every
call; the last line is ``{"ok": true, "device": {...}}``.
"""

from __future__ import annotations

import gc
import json
import os
import subprocess
import sys
import threading
import time
import urllib.request

import numpy as np
import torch

#: published H100 SXM HBM3 rate (NVIDIA data sheet), bytes/s
HBM_BYTES_PER_S = 3.35e12
#: published H100 SXM dense bf16 tensor-core rate (NVIDIA data sheet), FLOP/s
BF16_FLOPS_PER_S = 989e12
MAX_NEW = 32
PROMPT_LENS = (16, 23, 40, 64, 97, 128, 200, 256)


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

    Without the warm-up cycle a window can lose its first launches, the more
    the longer the process has run (torch 2.11 with CUDA 12.8 on an H100)."""
    from torch.profiler import ProfilerActivity, profile, schedule

    acts = [{"cpu": ProfilerActivity.CPU, "cuda": ProfilerActivity.CUDA}[a] for a in activities]
    with profile(activities=acts, schedule=schedule(wait=0, warmup=1, active=1, repeat=1)) as prof:
        run()
        prof.step()
        t0 = time.perf_counter()
        run()
        wall_ms = (time.perf_counter() - t0) * 1e3
        prof.step()
    return prof, wall_ms


def cuda_kernel_ms(prof, match: str) -> list:
    """Device ms of each kernel in a trace whose name holds ``match``."""
    from torch.autograd import DeviceType

    return [e.time_range.elapsed_us() / 1e3 for e in prof.events()
            if e.device_type == DeviceType.CUDA and match in e.name]


def kernel_device_ms(fn, match: str, iters: int = 50) -> float:
    """Mean execution time on the device of the kernels whose name holds
    ``match``, per launch (torch.profiler): the kernel alone, without the
    host-side launch cost that ``cuda_ms`` of back-to-back calls includes.
    The trace must hold every one of the ``iters`` launches."""
    def run():
        for _ in range(iters):
            fn()
        torch.cuda.synchronize()

    ms = cuda_kernel_ms(profiled(run)[0], match)
    if len(ms) != iters:
        raise AssertionError(f"profiler saw {len(ms)} {match} kernels for {iters} calls")
    return sum(ms) / iters


def device_ms_by_kernel(prof) -> dict:
    """Device time (ms) per kernel name in a torch.profiler trace. Spans of
    user annotations on the device timeline (``Optimizer.step#...``) are
    left out: they cover kernels counted on their own."""
    from torch.autograd import DeviceType

    by_name = {}
    for e in prof.events():
        if e.device_type == DeviceType.CUDA and not e.is_user_annotation:
            by_name[e.name] = by_name.get(e.name, 0.0) + e.time_range.elapsed_us() / 1e3
    return by_name


def max_abs_err(a: torch.Tensor, b: torch.Tensor) -> float:
    return float((a.float() - b.float()).abs().max())


# -- phase 2 -------------------------------------------------------------------

def kernel_phase(card: str):
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
    cur_d, tables_d = cur.to(dev), tables.to(dev)
    rows_v = torch.arange(S)[valid].to(dev)
    pos_v = cur[valid].long()
    blk_v = tables[torch.arange(S)[valid], pos_v // bt].long().to(dev)
    off_v = (pos_v % bt).to(dev)
    pos_v = pos_v.to(dev)
    new_v = new[valid.to(dev)]
    row = H * D * 2
    # bytes each write needs: the S cursors are read; only the n_valid slots
    # whose cursor is in range read their table entry and their row of
    # `new`, and write one arena row
    cursor_bytes, entry_bytes = S * 4, n_valid * 4

    results = {}

    def report(name, replaces, err, call, plain_ms, library_ms, nbytes):
        bound_ms = nbytes / HBM_BYTES_PER_S * 1e3
        ms = cuda_ms(call)
        results[name] = dict(name=name, route="cuda",
                             source="kubeflow_tpu_torch/ops/csrc/kv_cache.cu",
                             replaces=replaces, max_abs_err=err, ms=ms,
                             plain_ms=plain_ms, bound_ms=bound_ms, bound_by="bytes",
                             library_ms=library_ms)
        emit(phase="kernels", kernel=name, card=card, bit_equal=err == 0.0,
             kernel_ms=ms, kernel_device_ms=kernel_device_ms(call, name + "_kernel"),
             plain_ms=plain_ms, library_ms=library_ms,
             bound_ms=bound_ms, bytes=nbytes, launches_per_token=2 * n_layers)

    # kv_row_update
    a = kc.kv_row_update(cache.clone(), new, cur_d)
    b = kc.kv_row_update_plain(cache.clone(), new, cur_d)
    torch.cuda.synchronize()
    if not torch.equal(a, b):
        raise AssertionError("kv_row_update differs from its plain version")
    work = cache.clone()
    report("kv_row_update", "kubeflow_tpu/ops/kv_cache.py:45 (_kernel, pallas_call :93)",
           max_abs_err(a, b),
           lambda: kc.kv_row_update(work, new, cur_d),
           cuda_ms(lambda: kc.kv_row_update_plain(work, new, cur_d)),
           cuda_ms(lambda: work.index_put_((rows_v, pos_v), new_v)),
           cursor_bytes + 2 * n_valid * row)

    # kv_block_update
    a = kc.kv_block_update(arena.clone(), new, cur_d, tables_d, max_seq=T)
    b = kc.kv_block_update_plain(arena.clone(), new, cur_d, tables_d, max_seq=T)
    torch.cuda.synchronize()
    if not torch.equal(a, b):
        raise AssertionError("kv_block_update differs from its plain version")
    work = arena.clone()
    report("kv_block_update",
           "kubeflow_tpu/ops/kv_cache.py:117 (_paged_kernel, pallas_call :168)",
           max_abs_err(a, b),
           lambda: kc.kv_block_update(work, new, cur_d, tables_d, max_seq=T),
           cuda_ms(lambda: kc.kv_block_update_plain(work, new, cur_d, tables_d, max_seq=T)),
           cuda_ms(lambda: work.index_put_((blk_v, off_v), new_v)),
           cursor_bytes + entry_bytes + 2 * n_valid * row)

    # kv_block_update_quant
    qa, sa = kc.kv_block_update_quant(qarena.clone(), scales.clone(), new, cur_d,
                                      tables_d, max_seq=T)
    qb, sb = kc.kv_block_update_quant_plain(qarena.clone(), scales.clone(), new,
                                            cur_d, tables_d, max_seq=T)
    torch.cuda.synchronize()
    if not (torch.equal(qa, qb) and torch.equal(sa, sb)):
        raise AssertionError("kv_block_update_quant differs from its plain version")
    wq, ws = qarena.clone(), scales.clone()
    report("kv_block_update_quant",
           "kubeflow_tpu/ops/kv_cache.py:222 (_paged_quant_kernel, pallas_call :277)",
           max(max_abs_err(qa, qb), max_abs_err(sa, sb)),
           lambda: kc.kv_block_update_quant(wq, ws, new, cur_d, tables_d, max_seq=T),
           cuda_ms(lambda: kc.kv_block_update_quant_plain(wq, ws, new, cur_d, tables_d,
                                                          max_seq=T)),
           None,  # no single PyTorch call quantizes and scatters
           cursor_bytes + entry_bytes + n_valid * (row + H * D + H * 4))
    emit(phase="kernels", kernels=sorted(results), card=card)
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


def serve(prompts, card: str, label: str, **kw):
    """GPT-small behind ModelServer; one warm-up request, then every count
    reset and the 8 prompts sent concurrently. Returns (generated tokens
    per prompt, launch counts of the run)."""
    from kubeflow_tpu_torch.models.gpt import GptConfig
    from kubeflow_tpu_torch.ops import kv_cache as kc
    from kubeflow_tpu_torch.runtime.metrics import METRICS
    from kubeflow_tpu_torch.runtime.tracing import TRACER
    from kubeflow_tpu_torch.serving.server import ModelServer, gpt_served_model

    vocab = GptConfig.small().vocab_size
    model = gpt_served_model(name="gpt", tiny=False, max_new_tokens=MAX_NEW,
                             device="cuda", seed=0, **kw)
    server = ModelServer().add(model)
    httpd = server.serve(0)
    try:
        post(httpd.port, prompts[0][:16])  # warm-up: cuBLAS handles, allocator
        torch.cuda.synchronize()
        kc.reset_launches()
        METRICS.reset()
        TRACER.reset()
        out = [None] * len(prompts)
        errors = []

        def one(i):
            try:
                out[i] = post(httpd.port, prompts[i])
            except Exception as e:  # surfaced below, after every thread joined
                errors.append(e)

        threads = [threading.Thread(target=one, args=(i,)) for i in range(len(prompts))]
        t0 = time.perf_counter()
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=900)
        wall = time.perf_counter() - t0
        counts = dict(kc.LAUNCHES)
        if errors or any(o is None for o in out):
            raise RuntimeError(f"{label}: requests failed: {errors}")
        gen = []
        for p, o in zip(prompts, out):
            if o[:len(p)] != list(map(int, p)) or len(o) != len(p) + MAX_NEW:
                raise AssertionError(f"{label}: malformed prediction")
            toks = o[len(p):]
            if not all(0 <= t < vocab for t in toks):
                raise AssertionError(f"{label}: token outside the vocabulary")
            gen.append(toks)
        ttft = []
        for span in TRACER.finished_spans("serving.request"):
            ev = {e["name"]: e["timeUnixNano"] for e in span.events}
            if "first_token" in ev:
                ttft.append((ev["first_token"] - span.start_ns) / 1e6)
        chunk = METRICS.histogram("serving_decode_chunk_seconds")
        emit(phase=label, card=card, requests=len(prompts),
             generated_tokens=sum(len(t) for t in gen), wall_s=wall,
             tokens_per_s=sum(len(t) for t in gen) / wall,
             ttft_ms_p50=float(np.median(ttft)) if ttft else None,
             decode_chunk_ms_mean=(chunk.sum / chunk.total * 1e3) if chunk.total else None,
             decode_chunks=chunk.total, launches=counts,
             peak_mem_gib=torch.cuda.max_memory_allocated() / 2**30)
        return gen, counts
    finally:
        httpd.close()
        server.close()
        del model, server
        gc.collect()
        torch.cuda.empty_cache()


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
    paged bf16 arena, KV writes through the kernels, greedy argmax — the
    engine's per-token step without the engine. Host ms per step over 32
    steps; device kernel time (torch.profiler, CUPTI) over 8 more, as a
    share of their wall time (after a warm-up cycle of 8), and the top
    kernels by device time."""
    from kubeflow_tpu_torch.models.gpt import GptConfig, GptLM, init_params

    cfg = GptConfig.small()
    S, bt = 8, 16
    mb = cfg.max_seq // bt
    model = GptLM.bind(cfg, init_params(cfg, seed=0, device="cuda"), decode=True,
                       per_slot=True, kv_kernel=True, paged=True)
    arena = (S * mb + 1, bt, cfg.n_heads, cfg.head_dim)
    cache = {f"block_{i}": {"attention": {
        "k_arena": torch.zeros(arena, dtype=cfg.dtype, device="cuda"),
        "v_arena": torch.zeros(arena, dtype=cfg.dtype, device="cuda"),
        "cursors": torch.full((S,), 300, dtype=torch.int32, device="cuda")}}
        for i in range(cfg.n_layers)}
    tables = torch.arange(S * mb, dtype=torch.int32, device="cuda").view(S, mb)
    tok = torch.zeros((S,), dtype=torch.int32, device="cuda")

    def steps(n):
        nonlocal tok
        for _ in range(n):
            logits = model(tok[:, None], cache, block_tables=tables)
            tok = torch.argmax(logits[:, -1], dim=-1).to(torch.int32)
        torch.cuda.synchronize()

    with torch.no_grad():
        steps(3)
        t0 = time.perf_counter()
        steps(32)
        step_ms = (time.perf_counter() - t0) / 32 * 1e3
        prof, window_ms = profiled(lambda: steps(8), ("cpu", "cuda"))
    by_name = device_ms_by_kernel(prof)
    device_ms = sum(by_name.values())
    top = sorted(by_name.items(), key=lambda kv: -kv[1])[:8]
    emit(phase="profile", card=card, step_ms=step_ms, tokens_per_s=S * 1e3 / step_ms,
         device_ms_per_step=device_ms / 8 if device_ms else None,
         device_busy_share=device_ms / window_ms if device_ms else None,
         top_kernels_ms_per_step=[[n[:90], ms / 8] for n, ms in top])
    del model, cache
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
            "flash_bwd_dkv": (4 * dot, 2 * qb + 4 * kb + 2 * rows)}  # ... -> dk dv
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
        if out.abs().max() != 0 or not (lse == fa.NEG_BIG).all():
            raise AssertionError(f"flash {label}: fully masked rows must give 0 and -1e30")
    emit(phase="flash", case=label, shape=[b, lq, lk, h, d], dtype=str(dtype),
         causal=causal, q_offset=q_offset, k_offset=k_offset, bf16_dots=bf16_dots,
         max_abs_err=errs, limits=limits, max_abs={n: float(t.float().abs().max())
                                                   for n, t in zip(names, runs[0])},
         deterministic=True)
    return (q, k, v, do, kw), errs


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
    flash_case(fa, "bf16_dots", 2, 2, 256, 256, 64, torch.float32, 2e-2, 1e-3, bf16_dots=True)
    flash_case(fa, "bf16_dots_bf16", 2, 4, 512, 512, 64, torch.bfloat16, 2e-2, 1e-3,
               bf16_dots=True)

    # times at the main path's shapes
    out, lse = fa.flash_attention_fwd(q, k, v, **kw)
    delta = fa._delta(out, do)
    bwd_in = (q, k, v, do, lse, delta)
    calls = {
        "flash_fwd": (lambda: fa.flash_attention_fwd(q, k, v, **kw), "flash_fwd_kernel"),
        "flash_bwd_dq": (lambda: fa.bwd_dq_kernel(*bwd_in, **kw), "flash_bwd_dq_kernel"),
        "flash_bwd_dkv": (lambda: fa.bwd_dkv_kernel(*bwd_in, **kw), "flash_bwd_dkv_kernel"),
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
    bounds = flash_bounds(b, h, L, L, d, True, 0, 0, 2)
    results = {}
    for name, (call, match) in calls.items():
        ms = cuda_ms(call, iters=20, warmup=3)
        dev_ms = kernel_device_ms(call, match, iters=10)
        plain_ms = plain_fwd if name == "flash_fwd" else plain_bwd
        library_ms = lib_fwd if name == "flash_fwd" else lib_bwd
        bd = bounds[name]
        err = errs["out"] if name == "flash_fwd" else (
            errs["dq"] if name == "flash_bwd_dq" else max(errs["dk"], errs["dv"]))
        results[name] = dict(name=name, route="cuda", source=FLASH_SOURCE,
                             replaces=FLASH_REPLACES[name], max_abs_err=err, ms=ms,
                             plain_ms=plain_ms, bound_ms=bd["bound_ms"],
                             bound_by=bd["bound_by"], library_ms=library_ms)
        emit(phase="flash", kernel=name, card=card, kernel_ms=ms, kernel_device_ms=dev_ms,
             plain_ms=plain_ms, library_ms=library_ms, bound_ms=bd["bound_ms"],
             bound_by=bd["bound_by"], flops=bd["flops"], bytes=bd["bytes"],
             achieved_tflops=bd["flops"] / dev_ms / 1e9,
             library="sdpa forward" if name == "flash_fwd" else
             "sdpa backward (dq, dk and dv together: fwd+bwd minus fwd)",
             plain="plain forward" if name == "flash_fwd" else
             "plain backward (dq, dk and dv together)")
    del q, k, v, do, out, lse, delta, qt, kt, vt
    gc.collect()
    torch.cuda.empty_cache()
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
             step_ms_median=steady, tokens_per_s=tokens / steady * 1e3,
             mfu=res["flops_per_step"] / (steady / 1e3) / BF16_FLOPS_PER_S,
             flops_per_step=res["flops_per_step"],
             peak_mem_gib=torch.cuda.max_memory_allocated() / 2**30, launches=launches)
        if not all(np.isfinite(losses)) or not losses[-1] < losses[0]:
            raise AssertionError(f"train {label}: losses {losses}")
        want = cfg.n_layers * TRAIN_STEPS if attn is None else 0
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
    flash kernels' share (every one of their launches must be in the trace).
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
    prof, wall_ms = profiled(step, ("cpu", "cuda"))
    by_name = device_ms_by_kernel(prof)
    device_ms = sum(by_name.values())
    names = ("flash_fwd", "flash_bwd_dq", "flash_bwd_dkv")
    seen = {n: len(cuda_kernel_ms(prof, n + "_kernel")) for n in names}
    if seen != {n: cfg.n_layers for n in names}:
        raise AssertionError(f"train_profile: the trace holds {seen} flash launches, "
                             f"expected {cfg.n_layers} of each")
    flash_ms = {n: sum(cuda_kernel_ms(prof, n + "_kernel")) for n in names}
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


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: CUDA is not available", file=sys.stderr)
        return 2
    sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
    from kubeflow_tpu_torch.ops import _build

    card = smi()
    print(card, flush=True)
    t0 = time.perf_counter()
    _build.load_all()
    emit(phase="build", card=card, torch=torch.__version__, cuda=torch.version.cuda,
         build_s=time.perf_counter() - t0)

    kernels = kernel_phase(card)
    launches = serve_phases(card)
    ref_phase(card)
    profile_phase(card)
    kernels.update(flash_phase(card))
    train_ref_phase(card)
    launches.update(train_phase(card))
    train_profile_phase(card)
    for name, n in launches.items():
        kernels[name]["launches"] = n

    order = ("kv_row_update", "kv_block_update", "kv_block_update_quant",
             "flash_fwd", "flash_bwd_dq", "flash_bwd_dkv")
    emit(kernels=[kernels[k] for k in order])
    print(smi(), flush=True)
    emit(ok=True, device={"platform": "gpu", "kind": torch.cuda.get_device_name(0),
                          "count": torch.cuda.device_count()})
    return 0


def serve_phases(card: str) -> dict:
    """Phases 3-5: GPT-small served in three KV layouts, each held against
    its plain writes. Returns each KV kernel's launches in its layout's run."""
    rng = np.random.default_rng(0)
    prompts = [rng.integers(0, 32000, n).astype(np.int32) for n in PROMPT_LENS]

    bf16_k, c = serve(prompts, card, "serve_paged_kernel")  # default: the kernels
    if c["kv_block_update"] == 0:
        raise AssertionError("paged bf16 serving never launched kv_block_update")
    launches = {"kv_block_update": c["kv_block_update"]}
    bf16_p, c = serve(prompts, card, "serve_paged_plain", kv_kernel=False)
    if any(c.values()):
        raise AssertionError(f"kv_kernel=False launched kernels: {c}")
    if bf16_k != bf16_p:
        raise AssertionError("paged bf16: kernel-path tokens differ from plain-path tokens")

    contig, c = serve(prompts, card, "serve_contiguous_kernel", paged=False)
    if c["kv_row_update"] == 0:
        raise AssertionError("contiguous serving never launched kv_row_update")
    launches["kv_row_update"] = c["kv_row_update"]
    if contig != bf16_k:
        raise AssertionError("contiguous tokens differ from paged tokens")

    int8_k, c = serve(prompts, card, "serve_int8_kernel", kv_dtype="int8")
    if c["kv_block_update_quant"] == 0:
        raise AssertionError("int8 serving never launched kv_block_update_quant")
    launches["kv_block_update_quant"] = c["kv_block_update_quant"]
    int8_p, _ = serve(prompts, card, "serve_int8_plain", kv_kernel=False, kv_dtype="int8")
    if int8_k != int8_p:
        raise AssertionError("int8: kernel-path tokens differ from plain-path tokens")
    agree = np.mean([a == b for x, y in zip(int8_k, bf16_k) for a, b in zip(x, y)])
    emit(phase="int8_vs_bf16", card=card, token_agreement=float(agree))
    return launches


if __name__ == "__main__":
    sys.exit(main())
