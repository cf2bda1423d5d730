"""Chip smoke test of the PyTorch/CUDA port (``kubeflow_tpu_torch``).

Run from the repository root on a machine with one NVIDIA H100:

    python3 chip_smoke.py

Phases (any failure exits non-zero; nothing is caught and skipped):

1. build   — the card's name and power limit, torch/CUDA versions, and the
             build of every CUDA kernel from ``kubeflow_tpu_torch/ops/csrc``;
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
             device-busy share with the top kernels (torch.profiler).

The launch counts reported per kernel come from its serving phase: they
are reset just before the requests and read just after. The last line is
``{"ok": true, "device": {...}}``.
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


def kernel_device_ms(fn, match: str, iters: int = 50) -> float:
    """Mean execution time on the device of the kernels whose name holds
    ``match``, per call (torch.profiler): the kernel alone, without the
    host-side launch cost that ``cuda_ms`` of back-to-back calls includes."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(iters):
            fn()
        torch.cuda.synchronize()
    us = [e.time_range.elapsed_us() for e in prof.events()
          if e.device_type == DeviceType.CUDA and match in e.name]
    if len(us) != iters:
        raise AssertionError(f"profiler saw {len(us)} {match} kernels, expected {iters}")
    return sum(us) / iters / 1e3


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
    share of their wall time, and the top kernels by device time."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

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
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            steps(8)
            window_ms = (time.perf_counter() - t0) * 1e3
    by_name = {}
    for e in prof.events():
        if e.device_type == DeviceType.CUDA:
            by_name[e.name] = by_name.get(e.name, 0.0) + e.time_range.elapsed_us() / 1e3
    device_ms = sum(by_name.values())
    top = sorted(by_name.items(), key=lambda kv: -kv[1])[:8]
    emit(phase="profile", card=card, step_ms=step_ms, tokens_per_s=S * 1e3 / step_ms,
         device_ms_per_step=device_ms / 8 if device_ms else None,
         device_busy_share=device_ms / window_ms if device_ms else None,
         top_kernels_ms_per_step=[[n[:90], ms / 8] for n, ms in top])
    del model, cache
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
    _build.load("kv_cache.cu")
    emit(phase="build", card=card, torch=torch.__version__, cuda=torch.version.cuda,
         build_s=time.perf_counter() - t0)

    kernels = kernel_phase(card)

    rng = np.random.default_rng(0)
    prompts = [rng.integers(0, 32000, n).astype(np.int32) for n in PROMPT_LENS]

    bf16_k, c = serve(prompts, card, "serve_paged_kernel")  # default: the kernels
    if c["kv_block_update"] == 0:
        raise AssertionError("paged bf16 serving never launched kv_block_update")
    kernels["kv_block_update"]["launches"] = c["kv_block_update"]
    bf16_p, c = serve(prompts, card, "serve_paged_plain", kv_kernel=False)
    if any(c.values()):
        raise AssertionError(f"kv_kernel=False launched kernels: {c}")
    if bf16_k != bf16_p:
        raise AssertionError("paged bf16: kernel-path tokens differ from plain-path tokens")

    contig, c = serve(prompts, card, "serve_contiguous_kernel", paged=False)
    if c["kv_row_update"] == 0:
        raise AssertionError("contiguous serving never launched kv_row_update")
    kernels["kv_row_update"]["launches"] = c["kv_row_update"]
    if contig != bf16_k:
        raise AssertionError("contiguous tokens differ from paged tokens")

    int8_k, c = serve(prompts, card, "serve_int8_kernel", kv_dtype="int8")
    if c["kv_block_update_quant"] == 0:
        raise AssertionError("int8 serving never launched kv_block_update_quant")
    kernels["kv_block_update_quant"]["launches"] = c["kv_block_update_quant"]
    int8_p, _ = serve(prompts, card, "serve_int8_plain", kv_kernel=False, kv_dtype="int8")
    if int8_k != int8_p:
        raise AssertionError("int8: kernel-path tokens differ from plain-path tokens")
    agree = np.mean([a == b for x, y in zip(int8_k, bf16_k) for a, b in zip(x, y)])
    emit(phase="int8_vs_bf16", card=card, token_agreement=float(agree))

    ref_phase(card)
    profile_phase(card)

    order = ("kv_row_update", "kv_block_update", "kv_block_update_quant")
    emit(kernels=[kernels[k] for k in order])
    print(smi(), flush=True)
    emit(ok=True, device={"platform": "gpu", "kind": torch.cuda.get_device_name(0),
                          "count": torch.cuda.device_count()})
    return 0


if __name__ == "__main__":
    sys.exit(main())
