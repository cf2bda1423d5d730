"""Device-ceiling probe: what the card actually sustains.

The port of ``e2e/ceiling.py``. Every row is timed the same way
(:func:`timed`): one warm-up call, then CUDA events around back-to-back
calls of a chain of ``chain`` dependent operations, each reading the
previous one's output, so the device runs them in order and the host's
launches hide behind them. Eager PyTorch needs no scan and no fetch.

Rows (keys ``kernel``, ``tflops`` or ``gbs``, ``iter_s``, as in JAX):

- bf16 matmul chain ``y <- y @ W`` at several sizes — the tensor-core
  ceiling (``torch.matmul``, cuBLAS);
- ResNet-dominant 3x3 convolutions at the real per-stage shapes, bf16
  channels-last (``F.conv2d``, cuDNN) — the convolution ceiling;
- the port's flash-attention kernels, forward and backward, at long
  sequence lengths (8192 tokens held constant) — kernels 4-6 beside them;
- an f32 triad ``y <- |y| * 0.9999 + x`` — the HBM ceiling.

The matmul and convolution rows measure the card's library ceilings, as
the JAX rows measure XLA's; they port no Pallas kernel.

Run on the card: ``python -m kubeflow_tpu_torch.e2e.ceiling [--flash]``;
at toy size on the CPU the row functions take ``device="cpu"`` (host-clock
times of the CPU, no device metric).
"""

from __future__ import annotations

import argparse
import json
import time
from typing import Any, Callable, Dict, List, Optional

import torch
import torch.nn.functional as F

from ..device import DeviceLike, resolve_device

#: dependent operations per timed call (the JAX probe's CEILING_CHAIN)
CHAIN = 8


def timed(fn: Callable[[], Any], iters: int, warmup: int = 1,
          device: DeviceLike = "cuda") -> float:
    """Seconds per call of ``fn``, whose work runs on ``device``: ``warmup``
    untimed calls, then ``iters`` back-to-back calls between two CUDA
    events on the current stream (the host clock for the CPU)."""
    dev = resolve_device(device)
    for _ in range(warmup):
        fn()
    if dev.type != "cuda":
        t0 = time.perf_counter()
        for _ in range(iters):
            fn()
        return (time.perf_counter() - t0) / iters
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / 1e3 / iters


def _randn(*shape: int, dtype: torch.dtype, device: torch.device) -> torch.Tensor:
    g = torch.Generator(device=device).manual_seed(0)
    return torch.randn(*shape, generator=g, dtype=dtype, device=device)


def matmul_flops(n: int) -> float:
    return 2.0 * n * n * n


def matmul_sustained(n: int, iters: int = 20, chain: int = CHAIN,
                     device: DeviceLike = "cuda") -> Dict[str, Any]:
    """bf16 ``y <- y @ W`` chained n x n matmul; sustained TFLOP/s."""
    dev = resolve_device(device)
    # scaled init keeps values finite across the chained multiplies
    w = _randn(n, n, dtype=torch.bfloat16, device=dev) * (1.0 / n) ** 0.5
    y0 = _randn(n, n, dtype=torch.bfloat16, device=dev)

    def run():
        y = y0
        for _ in range(chain):
            y = y @ w
        return y

    dt = timed(run, iters, device=dev) / chain
    return {"kernel": f"matmul_bf16_{n}", "tflops": matmul_flops(n) / dt / 1e12, "iter_s": dt}


def conv_flops(batch: int, hw: int, cin: int, cout: int) -> float:
    """A 3x3 stride-1 SAME convolution and its 1x1 projection back."""
    return 2.0 * batch * hw * hw * (3 * 3 * cin * cout + cout * cin)


def conv_sustained(batch: int, hw: int, cin: int, cout: int, iters: int = 20,
                   chain: int = CHAIN, device: DeviceLike = "cuda") -> Dict[str, Any]:
    """bf16 3x3 stride-1 SAME convolution at a ResNet-stage shape, channels
    last; sustained TFLOP/s."""
    dev = resolve_device(device)
    cl = torch.channels_last
    x0 = _randn(batch, cin, hw, hw, dtype=torch.bfloat16, device=dev).contiguous(memory_format=cl)
    k = (_randn(cout, cin, 3, 3, dtype=torch.bfloat16, device=dev) * 0.05).contiguous(
        memory_format=cl)
    # cout -> cin projection so the chain composes when cin != cout
    proj = (_randn(cin, cout, 1, 1, dtype=torch.bfloat16, device=dev) * 0.05).contiguous(
        memory_format=cl)

    def run():
        x = x0
        for _ in range(chain):
            y = F.conv2d(x, k, padding=1)
            x = F.conv2d(y, proj) * (1.0 / hw)
        return x

    dt = timed(run, iters, device=dev) / chain
    return {"kernel": f"conv3x3_bf16_b{batch}_{hw}x{hw}x{cin}->{cout}",
            "tflops": conv_flops(batch, hw, cin, cout) / dt / 1e12, "iter_s": dt}


def b_h_l2_d(b: int, h: int, l: int, d: int) -> float:
    return b * h * float(l) * l * d  # one causal-triangle matmul's MACs*2/2


def flash_flops(batch: int, seq: int, heads: int, head_dim: int) -> float:
    """Causal forward = 2 matmuls over the lower triangle; the backward
    recomputes the scores and adds 4 more matmuls, ~2.5x the forward."""
    return 3.5 * 2.0 * b_h_l2_d(batch, heads, seq, head_dim)


def flash_seq_sustained(batch: int, seq: int, heads: int = 16, head_dim: int = 64,
                        iters: int = 8, chain: int = CHAIN,
                        device: DeviceLike = "cuda") -> Dict[str, Any]:
    """The port's flash attention forward + backward (the CUDA kernels on
    the card) at long sequence lengths; sustained TFLOP/s."""
    from ..ops.flash_attention import flash_attention

    dev = resolve_device(device)
    q0 = _randn(batch, seq, heads, head_dim, dtype=torch.bfloat16, device=dev) * 0.1
    small = torch.tensor(1e-3, dtype=torch.bfloat16)

    def run():
        q = q0
        for _ in range(chain):
            qq, kk, vv = (q.detach().requires_grad_(True) for _ in range(3))
            loss = flash_attention(qq, kk, vv, causal=True).float().abs().sum()
            dq, dk, dv = torch.autograd.grad(loss, (qq, kk, vv))
            q = (dq.abs() * 0.1 + (dk.abs() + dv.abs()) * small).to(torch.bfloat16) * 0.3
        return q

    dt = timed(run, iters, device=dev) / chain
    return {"kernel": f"flash_attn_fwd_bwd_b{batch}_L{seq}",
            "tflops": flash_flops(batch, seq, heads, head_dim) / dt / 1e12, "iter_s": dt}


#: array passes of one triad step in eager PyTorch: ``abs`` reads y and
#: writes |y|; ``add`` reads x and |y| and writes y
TRIAD_PASSES = 5


def hbm_triad(mib: int = 512, iters: int = 20, chain: int = CHAIN,
              device: DeviceLike = "cuda") -> Dict[str, Any]:
    """f32 ``y <- |y| * 0.9999 + x`` -> GB/s. ``abs()`` keeps each chain
    step non-linear. XLA fuses the JAX chain into one kernel and counts 3
    array passes an iteration; eager PyTorch launches ``abs`` and ``add``
    per step, so the bytes counted are those its own launches move:
    :data:`TRIAD_PASSES` array passes per step, ``chain`` steps an
    iteration."""
    dev = resolve_device(device)
    n = mib * 1024 * 1024 // 4
    x = _randn(n, dtype=torch.float32, device=dev)
    y0 = _randn(n, dtype=torch.float32, device=dev)

    def run():
        y = y0
        for _ in range(chain):
            y = torch.add(x, torch.abs(y), alpha=0.9999)
        return y

    dt = timed(run, iters, device=dev)
    gbytes = TRIAD_PASSES * chain * n * 4 / 1e9
    return {"kernel": f"hbm_triad_f32_{mib}MiB", "gbs": gbytes / dt, "iter_s": dt}


MATMUL_SIZES = (2048, 4096, 8192)
#: ResNet-50's 3x3 convolutions by stage, at the bench's batch
CONV_SHAPES = ((256, 56, 64, 64), (256, 28, 128, 128), (256, 14, 256, 256))
#: long-context flash rows: 8192 tokens held constant
FLASH_SHAPES = ((8, 1024), (4, 2048), (2, 4096), (1, 8192))


def sweep(iters: int = 20, chain: int = CHAIN, device: DeviceLike = "cuda") -> Dict[str, Any]:
    results: List[Dict[str, Any]] = []
    for n in MATMUL_SIZES:
        results.append(matmul_sustained(n, iters, chain, device))
    for shape in CONV_SHAPES:
        results.append(conv_sustained(*shape, iters=iters, chain=chain, device=device))
    bw = hbm_triad(iters=iters, chain=chain, device=device)
    ceiling = max(r["tflops"] for r in results)
    return {"kernels": results, "hbm": bw, "ceiling_tflops": ceiling}


def flash_sweep(iters: int = 8, chain: int = CHAIN,
                device: DeviceLike = "cuda") -> List[Dict[str, Any]]:
    """Long-context flash rows (``--flash``)."""
    return [flash_seq_sustained(b, L, iters=iters, chain=chain, device=device)
            for b, L in FLASH_SHAPES]


def main(argv: Optional[List[str]] = None) -> int:
    from ..training.flops import detect_generation, peak_flops_per_chip, peak_hbm_bandwidth

    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--flash", action="store_true", help="the long-context flash rows")
    ap.add_argument("--chain", type=int, default=CHAIN)
    args = ap.parse_args(argv)
    gen = detect_generation()
    peak = peak_flops_per_chip(gen) / 1e12
    card = torch.cuda.get_device_name()
    if args.flash:
        rows = flash_sweep(chain=args.chain)
        for r in rows:
            print(f"{r['kernel']:45s} {r['tflops']:9.1f} TF {100 * r['tflops'] / peak:7.1f}%")
        print(json.dumps({"metric": f"flash_seq_sweep_{gen}", "device": card, "rows": rows}))
        return 0
    out = sweep(chain=args.chain)
    print(f"{'kernel':45s} {'sustained':>12s} {'of peak':>8s}")
    for r in out["kernels"]:
        print(f"{r['kernel']:45s} {r['tflops']:9.1f} TF {100 * r['tflops'] / peak:7.1f}%")
    b = out["hbm"]
    hbm_peak = peak_hbm_bandwidth(gen) / 1e9
    print(f"{b['kernel']:45s} {b['gbs']:9.1f} GB/s {100 * b['gbs'] / hbm_peak:6.1f}%")
    print(json.dumps({
        "metric": f"kernel_ceiling_{gen}",
        "device": card,
        "value": round(out["ceiling_tflops"], 1),
        "unit": "tflops_sustained",
        "peak_tflops": peak,
        "of_peak": round(out["ceiling_tflops"] / peak, 4),
        "hbm_gbs": round(b["gbs"], 1),
        "rows": out["kernels"] + [b],
    }))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
