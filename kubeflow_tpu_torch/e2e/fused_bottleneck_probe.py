"""Fused-bottleneck kernel evidence: can a hand-written kernel stream device
memory as fast as the framework's own code?

The port of ``e2e/fused_bottleneck_probe.py``, at its shapes (stage 1 of
ResNet-50 at batch 256: ``N, HW, CIN, CMID = 256, 56, 256, 64``) and on its
seeded inputs (numpy ``RandomState(0)``, drawn in the JAX probe's order).
Six rows:

1. ``torch_composite`` — the composite of the block
   (:func:`~kubeflow_tpu_torch.ops.fused_bottleneck.reference_bottleneck`,
   cuDNN convolutions), the thing the kernel must beat;
2. ``fused_cuda`` — the ``fused_bottleneck`` kernel on the same block;
3. ``torch_mul_2d`` — ``torch.mul`` by ``SCALE`` over the flat
   ``[N*HW*HW, CIN]`` array: the library's own streaming, the yardstick;
4. ``stream_copy_2d`` / 5. ``stream_copy_4d`` — the ``stream_copy`` kernel
   (the Pallas block-pipelined copy) with 2-D blocks ``(3136, CIN)`` and
   4-D blocks ``(1, HW, HW, CIN)``;
6. ``stream_copy_dma`` — the ``stream_copy_dma`` kernel (the Pallas hand
   double-buffered DMA copy), ``bm`` 4096.

The accounting is the JAX probe's: a block pass does
``2 N HW^2 (CIN CMID + 9 CMID^2 + CMID CIN)`` FLOPs, and a copy moves
``2 * nbytes`` (read and write: ``gbps_rw``). So is the chain: a block row
runs ``chain`` passes an iteration, each followed by the chain step
``y * SCALE`` (:func:`chain_step`), for 8 iterations; a copy row runs 4
copies an iteration for 8 iterations, each reading the previous output.
Times come from :func:`~kubeflow_tpu_torch.e2e.ceiling.timed` (CUDA
events after a warm-up run).

Run on the card: ``python -m kubeflow_tpu_torch.e2e.fused_bottleneck_probe``.
"""

from __future__ import annotations

import argparse
import json
from typing import Any, Callable, Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from ..device import DeviceLike, resolve_device
from ..ops.stream_copy import SCALE, stream_copy, stream_copy_dma, stream_copy_plain
from .ceiling import CHAIN, timed

N, HW, CIN, CMID = 256, 56, 256, 64
#: scan iterations of every row, and copies per iteration of a copy row
ITERS, COPIES = 8, 4

Weights = Tuple[torch.Tensor, ...]


def inputs(n: int = N, hw: int = HW, cin: int = CIN, cmid: int = CMID,
           device: DeviceLike = "cuda") -> Tuple[torch.Tensor, Weights]:
    """The JAX probe's ``_inputs`` at these shapes: bf16 x times bf16(0.3)
    (JAX's weak-typed 0.3 is rounded to bf16 first), bf16 weights, f32
    folded norms."""
    dev = resolve_device(device)
    rng = np.random.RandomState(0)
    bf16 = torch.bfloat16
    x0 = torch.as_tensor(rng.randn(n, hw, hw, cin)).to(bf16) * torch.tensor(0.3, dtype=bf16)
    w1 = torch.as_tensor(rng.randn(cin, cmid) * 0.05).to(bf16)
    w2 = torch.as_tensor(rng.randn(3, 3, cmid, cmid) * 0.05).to(bf16)
    w3 = torch.as_tensor(rng.randn(cmid, cin) * 0.05).to(bf16)
    ones = lambda c: torch.ones(c, dtype=torch.float32)  # noqa: E731
    zeros = lambda c: torch.zeros(c, dtype=torch.float32)  # noqa: E731
    weights = (w1, ones(cmid), zeros(cmid) + 0.01, w2, ones(cmid) * 1.1, zeros(cmid) - 0.01,
               w3, ones(cin) * 0.9, zeros(cin))
    return x0.to(dev), tuple(w.to(dev) for w in weights)


def block_flops(n: int = N, hw: int = HW, cin: int = CIN, cmid: int = CMID) -> float:
    return 2.0 * n * hw * hw * (cin * cmid + 9 * cmid * cmid + cmid * cin)


def copy_bytes(x: torch.Tensor) -> float:
    """Bytes one copy moves: x read once and the output written once."""
    return 2.0 * x.numel() * x.element_size()


def chain_step(fn: Callable[..., torch.Tensor], x: torch.Tensor,
               weights: Weights) -> torch.Tensor:
    """One pass of a block row: the block, then ``* bf16(0.97)`` in bf16."""
    return fn(x, *weights) * SCALE


def bench_block(fn: Callable[..., torch.Tensor], x0: torch.Tensor, weights: Weights,
                label: str, chain: int = CHAIN, iters: int = ITERS) -> Dict[str, Any]:
    n, hw, _, cin = x0.shape
    flops = block_flops(n, hw, cin, weights[0].shape[1])

    def run():
        x = x0
        for _ in range(iters * chain):
            x = chain_step(fn, x, weights)
        return x

    dt = timed(run, 1, device=x0.device) / (iters * chain)
    return {"probe": label, "ms_per_pass": dt * 1e3, "tflops": flops / dt / 1e12}


def bench_copy(fn: Callable[[torch.Tensor], torch.Tensor], x0: torch.Tensor, label: str,
               iters: int = ITERS, copies: int = COPIES) -> Dict[str, Any]:
    def run():
        x = x0
        for _ in range(iters * copies):
            x = fn(x)
        return x

    dt = timed(run, 1, device=x0.device) / (iters * copies)
    return {"probe": label, "ms_per_pass": dt * 1e3, "gbps_rw": copy_bytes(x0) / dt / 1e9}


def probe_rows(x0: torch.Tensor, weights: Weights, chain: int = CHAIN,
               iters: int = ITERS, copy_block: Optional[Sequence[int]] = None,
               bm: int = 4096) -> List[Dict[str, Any]]:
    """The six rows on ``x0``/``weights`` (any shapes the kernels take;
    ``copy_block`` defaults to the JAX probe's ``(3136, cin)``)."""
    from ..ops.fused_bottleneck import fused_bottleneck, reference_bottleneck

    n, hw, _, cin = x0.shape
    flat = x0.reshape(n * hw * hw, cin)
    block2 = tuple(copy_block) if copy_block is not None else (3136, cin)
    return [
        bench_block(reference_bottleneck, x0, weights, "torch_composite", chain, iters),
        bench_block(fused_bottleneck, x0, weights, "fused_cuda", chain, iters),
        bench_copy(stream_copy_plain, flat, "torch_mul_2d", iters),
        bench_copy(lambda x: stream_copy(x, block2), flat, "stream_copy_2d", iters),
        bench_copy(lambda x: stream_copy(x, (1, hw, hw, cin)), x0, "stream_copy_4d", iters),
        bench_copy(lambda x: stream_copy_dma(x, bm), flat, "stream_copy_dma", iters),
    ]


def main(argv: Optional[List[str]] = None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--chain", type=int, default=CHAIN)
    args = ap.parse_args(argv)
    x0, weights = inputs()
    rows = probe_rows(x0, weights, chain=args.chain)
    for r in rows:
        print(json.dumps(r), flush=True)
    print(json.dumps({"metric": "fused_bottleneck_probe",
                      "device": torch.cuda.get_device_name(x0.device), "rows": rows}))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
