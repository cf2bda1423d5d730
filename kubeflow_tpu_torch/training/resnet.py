"""The ResNet-50 training step of the JAX package's bench, in PyTorch.

The port of ``bench.py``'s ``_bench`` train step: ``ResNet50(num_classes=1000,
stem="s2d", fused_blocks=True)`` at batch 256 on 224 x 224 x 3 NHWC images,
bf16 compute with f32 parameters and f32 BatchNorm statistics, and
``sgd_momentum(lr=0.1, total_steps=1000)`` (weight decay 1e-4 on every
parameter, Nesterov momentum 0.9, lr 0 at step 0 then a cosine from 0.1).
All 16 bottlenecks run the CUDA kernels: the 12 identity blocks
``fused_bottleneck``, the 4 stage heads ``fused_transition``. Images and
labels are drawn once from numpy with the seed and the same batch repeats
every step, as in the bench (which draws them from ``jax.random``).

Run on the card (the default device)::

    python -m kubeflow_tpu_torch.training.resnet --steps 8

or at a tiny size on the CPU, through the kernels' plain versions::

    python -m kubeflow_tpu_torch.training.resnet --steps 3 --tiny --device cpu

Each step prints one JSON line: loss, accuracy, step ms, images/s; the
last line holds the FLOP counts, mfu (on the card), the step breakdown and
the peak device memory.
"""

from __future__ import annotations

import argparse
import functools
import json
from dataclasses import dataclass
from typing import Any, Callable, Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from ..device import DeviceLike, resolve_device
from ..gpu.profiling import StepClock, step_breakdown
from ..models.resnet import BottleneckBlock, ResNet
from ..ops import _build
from ..runtime.tracing import TRACER
from . import flops
from .classifier import ClassifierTask, sgd_momentum

#: ``bench.py``'s fallback FLOP count: ResNet-50's forward at 224 x 224 is
#: ~8.2 GFLOP an image (2 x MACs), a train step ~3 x the forward
ANALYTIC_FWD_FLOPS_PER_IMAGE = 8.2e9


@dataclass(frozen=True)
class ResNetBenchConfig:
    stage_sizes: Sequence[int] = (3, 4, 6, 3)
    num_classes: int = 1000
    num_filters: int = 64
    stem: str = "s2d"
    fused_blocks: bool = True
    batch: int = 256
    image: int = 224
    lr: float = 0.1
    total_steps: int = 1000


def bench_config() -> ResNetBenchConfig:
    """The bench's configuration (``bench.py`` ``_bench``, batch 256)."""
    return ResNetBenchConfig()


def tiny_config() -> ResNetBenchConfig:
    """Two stages of two bottlenecks (a stage head and an identity block
    each), 16 filters, 10 classes, batch 4 of 32 x 32 images."""
    return ResNetBenchConfig(stage_sizes=(2, 2), num_classes=10, num_filters=16, batch=4,
                             image=32)


def make_model(cfg: ResNetBenchConfig, *, seed: int = 0, device: DeviceLike = "cuda",
               fused_blocks: Optional[bool] = None, plain_kernels: bool = False) -> ResNet:
    fused = cfg.fused_blocks if fused_blocks is None else fused_blocks
    return ResNet(cfg.stage_sizes, BottleneckBlock, num_classes=cfg.num_classes,
                  num_filters=cfg.num_filters, stem=cfg.stem, fused_blocks=fused,
                  plain_kernels=plain_kernels, seed=seed, device=device)


def make_batch(cfg: ResNetBenchConfig, seed: int, device: DeviceLike
               ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Seeded f32 normal images [b, image, image, 3] and labels, on ``device``."""
    rng = np.random.default_rng(seed)
    images = rng.standard_normal((cfg.batch, cfg.image, cfg.image, 3), dtype=np.float32)
    labels = rng.integers(0, cfg.num_classes, cfg.batch)
    return (torch.as_tensor(images, device=device),
            torch.as_tensor(labels, dtype=torch.int64, device=device))


def flops_per_step(batch: int) -> float:
    """The bench's analytic FLOP count of one step: 3 x the analytic
    forward."""
    return 3.0 * ANALYTIC_FWD_FLOPS_PER_IMAGE * batch


def make_task(cfg: ResNetBenchConfig, model: ResNet) -> ClassifierTask:
    return ClassifierTask(model, functools.partial(sgd_momentum, lr=cfg.lr,
                                                   total_steps=cfg.total_steps))


def counted_flops_per_step(cfg: ResNetBenchConfig, images: torch.Tensor,
                           labels: torch.Tensor, seed: int = 0) -> float:
    """The step's FLOPs as ``bench.py`` counts them: one train step of the
    UNFUSED model (the same math; the fused blocks' kernels are invisible
    to the counter, as a Pallas call is to XLA's cost analysis), counted by
    :func:`flops.counted_flops` on a throwaway model on ``images``'s
    device."""
    model = make_model(cfg, seed=seed, device=images.device, fused_blocks=False)
    task = make_task(cfg, model)
    return float(flops.counted_flops(task.train_step, task.init(), images, labels))


def train(cfg: ResNetBenchConfig, *, steps: int, seed: int = 0, device: DeviceLike = "cuda",
          fused_blocks: Optional[bool] = None, plain_kernels: bool = False,
          on_step: Optional[Callable[[Dict[str, Any]], None]] = None) -> Dict[str, Any]:
    """``steps`` SGD steps from seeded weights on one seeded batch.

    Each step runs under a :class:`StepClock`: ``compute`` around the step's
    dispatch, ``fetch`` around the read of its loss (which waits for the
    device); the kernels' first-use build is charged to ``compile``. Returns
    the per-step losses, accuracies and step times, the images per step,
    the step's counted FLOPs (:func:`counted_flops_per_step`) beside the
    bench's analytic count, ``mfu`` of the median step after the first (on
    the card; None on the CPU, which has no catalog peak), the
    ``step_breakdown`` and ``peak_hbm_bytes`` of the training loop (None on
    the CPU). ``on_step`` gets each step's record."""
    dev = resolve_device(device)
    images, labels = make_batch(cfg, seed, dev)
    clock = StepClock(tracer=TRACER)
    fused = cfg.fused_blocks if fused_blocks is None else fused_blocks
    if dev.type == "cuda" and fused and not plain_kernels:
        with clock.compile():
            _build.load("fused_bottleneck.cu")
    counted = counted_flops_per_step(cfg, images, labels, seed)
    if dev.type == "cuda":
        torch.cuda.reset_peak_memory_stats(dev)
    model = make_model(cfg, seed=seed, device=dev, fused_blocks=fused_blocks,
                       plain_kernels=plain_kernels)
    task = make_task(cfg, model)
    state = task.init()
    losses: List[float] = []
    accuracy: List[float] = []
    step_ms: List[float] = []
    clock.mark()
    for step in range(steps):
        with clock.compute():
            state, metrics = task.train_step(state, images, labels)
        with clock.fetch():
            loss = float(metrics["loss"])
        ms = clock.end_step()["total"] * 1e3
        losses.append(loss)
        accuracy.append(float(metrics["accuracy"]))
        step_ms.append(ms)
        if on_step is not None:
            on_step({"step": step + 1, "loss": loss, "accuracy": accuracy[-1],
                     "step_ms": ms, "images_per_s": cfg.batch / ms * 1e3})
    steady_s = float(np.median(step_ms[1:] or step_ms)) / 1e3
    mem = flops.memory_stats(dev)
    return {"losses": losses, "accuracy": accuracy, "step_ms": step_ms,
            "images_per_step": cfg.batch, "flops_per_step": counted,
            "analytic_flops_per_step": flops_per_step(cfg.batch),
            "mfu": (flops.mfu(counted, steady_s, generation=flops.detect_generation(dev))
                    if dev.type == "cuda" else None),
            "step_breakdown": step_breakdown(clock),
            "peak_hbm_bytes": mem["peak_hbm_bytes"] if mem else None,
            "n_params": sum(p.numel() for p in model.parameters())}


def main(argv: Optional[List[str]] = None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--steps", type=int, default=8)
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--tiny", action="store_true",
                    help="a two-stage, 16-filter ResNet, batch 4 of 32 x 32 images "
                         "(for --device cpu)")
    args = ap.parse_args(argv)
    cfg = tiny_config() if args.tiny else bench_config()
    result = train(cfg, steps=args.steps, device=args.device,
                   on_step=lambda r: print(json.dumps(r), flush=True))
    keys = ("n_params", "flops_per_step", "analytic_flops_per_step", "mfu",
            "step_breakdown", "peak_hbm_bytes")
    print(json.dumps({k: result[k] for k in keys}), flush=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
