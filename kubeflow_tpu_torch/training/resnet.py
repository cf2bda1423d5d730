"""The ResNet-50 training step of the JAX package's bench, in PyTorch.

The port of ``bench.py``'s ``_bench`` train step: ``ResNet50(num_classes=1000,
stem="s2d", fused_blocks=True)`` at batch 256 on 224 x 224 x 3 NHWC images,
bf16 compute with f32 parameters and f32 BatchNorm statistics, and
``sgd_momentum(lr=0.1, total_steps=1000)`` (weight decay 1e-4 on every
parameter, Nesterov momentum 0.9, lr 0 at step 0 then a cosine from 0.1).
With fused blocks all 16 bottlenecks run the CUDA kernels: the 12
identity blocks ``fused_bottleneck``, the 4 stage heads
``fused_transition``. Like the bench (``BENCH_FUSED=auto``), the command
line measures the fused and the unfused model first and trains with the
faster (``train(fused_blocks="auto")``). Images and labels are drawn once
from numpy with the seed and the same batch repeats every step, as in the
bench (which draws them from ``jax.random``).

Run on the card (the default device)::

    python -m kubeflow_tpu_torch.training.resnet --steps 8

or at a tiny size on the CPU, through the kernels' plain versions::

    python -m kubeflow_tpu_torch.training.resnet --steps 3 --tiny --device cpu

Each step prints one JSON line: loss, accuracy, step ms, images/s; the
last line holds the FLOP counts, mfu (on the card), the step breakdown,
the peak device memory, the sweep's ``autotune`` row and the
``attribution`` row.
"""

from __future__ import annotations

import argparse
import functools
import json
import time
from dataclasses import dataclass
from typing import Any, Callable, Dict, List, Optional, Sequence, Tuple, Union

import numpy as np
import torch

from ..device import DeviceLike, resolve_device, synchronize
from ..gpu.profiling import StepClock, step_breakdown
from ..models.resnet import BottleneckBlock, ResNet
from ..ops import _build
from ..runtime.tracing import TRACER
from . import flops
from .attribution import attribute_resnet, attribution_row, loop_generation, record_step_peak_hbm
from .autotune import sweep
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


#: the ResNet sweep's candidates (``bench.py`` ``_bench``, ``BENCH_FUSED=auto``)
FUSED_CANDIDATES = [{"fused_blocks": False}, {"fused_blocks": True}]

Observer = Callable[[str, Dict[str, Any]], None]


def sweep_fused(cfg: ResNetBenchConfig, images: torch.Tensor, labels: torch.Tensor, *,
                calib_steps: int, seed: int = 0, plain_kernels: bool = False,
                observe: Optional[Observer] = None):
    """``bench.py``'s ``BENCH_FUSED=auto``: the fused kernel set against the
    unfused model, measured head to head by :func:`autotune.sweep` (no
    price; strict: a candidate that fails to run raises). Each candidate is a fresh model from ``seed``: one warm-up step,
    then ``calib_steps`` timed steps ended by a read of the last loss.
    ``observe("candidate", {"knobs", "steps", "seconds"})`` follows each
    measured candidate. Returns the :class:`AutotuneResult`."""
    def measure(knobs: Dict[str, Any]) -> float:
        model = make_model(cfg, seed=seed, device=images.device,
                           fused_blocks=knobs["fused_blocks"], plain_kernels=plain_kernels)
        task = make_task(cfg, model)
        state = task.init()
        state, metrics = task.train_step(state, images, labels)  # warm-up
        float(metrics["loss"])
        t0 = time.perf_counter()
        for _ in range(calib_steps):
            state, metrics = task.train_step(state, images, labels)
        float(metrics["loss"])
        seconds = (time.perf_counter() - t0) / calib_steps
        if observe is not None:
            observe("candidate", {"knobs": dict(knobs), "steps": calib_steps + 1,
                                  "seconds": seconds})
        return seconds

    return sweep("resnet", FUSED_CANDIDATES, measure=measure, strict=True)


@dataclass
class Prepared:
    """What :func:`prepare` hands a training loop: the device and its
    generation (:func:`attribution.loop_generation`), the seeded batch, the
    fused choice with its ``autotune`` row (and ``calibration``, the
    sweep's seconds a step, after a sweep), the step's counted FLOPs, and
    the model, its task and the task's initial state."""
    cfg: ResNetBenchConfig
    device: torch.device
    generation: str
    images: torch.Tensor
    labels: torch.Tensor
    fused: bool
    autotune: Dict[str, Any]
    calibration: Optional[Dict[str, float]]
    flops_per_step: float
    model: ResNet
    task: ClassifierTask
    state: Any


def prepare(cfg: ResNetBenchConfig, *, steps: int, clock: StepClock, seed: int = 0,
            device: DeviceLike = "cuda", fused_blocks: Union[None, bool, str] = None,
            plain_kernels: bool = False, observe: Optional[Observer] = None) -> Prepared:
    """Everything a training loop of ``steps`` steps needs before its first
    step, shared by :func:`train` and the bench's timed windows.

    ``fused_blocks``: None takes the config's, True/False pins it (the
    ``autotune`` row says so), ``"auto"`` measures both first
    (:func:`sweep_fused` at ``calib_steps = max(4, min(10, steps))``) and
    keeps the faster, as ``bench.py``'s ``BENCH_FUSED=auto``; ``observe``
    gets each swept candidate's stage and then ``("sweep", {"result":
    AutotuneResult})``. The kernels' first-use build is charged to
    ``clock.compile``. The step's FLOPs are :func:`counted_flops_per_step`;
    the device's peak memory counter is reset before the model is built."""
    if fused_blocks not in (None, True, False, "auto"):
        raise ValueError(f"fused_blocks must be None, True, False or 'auto', "
                         f"got {fused_blocks!r}")
    dev = resolve_device(device)
    images, labels = make_batch(cfg, seed, dev)
    if fused_blocks == "auto" or (cfg.fused_blocks if fused_blocks is None else fused_blocks):
        if dev.type == "cuda" and not plain_kernels:
            with clock.compile():
                _build.load("fused_bottleneck.cu")
    calibration = None
    if fused_blocks == "auto":
        result = sweep_fused(cfg, images, labels, calib_steps=max(4, min(10, steps)),
                             seed=seed, plain_kernels=plain_kernels, observe=observe)
        fused = bool(result.chosen["fused_blocks"])
        autotune_row = result.to_row()
        if observe is not None:
            observe("sweep", {"result": result})
        # bench.py's legacy row, kept for comparisons with its history
        calibration = {("fused" if c.knobs["fused_blocks"] else "unfused"):
                       round(c.measured_seconds, 6) for c in result.candidates}
    else:
        fused = cfg.fused_blocks if fused_blocks is None else fused_blocks
        autotune_row = {"family": "resnet", "chosen": {"fused_blocks": fused},
                        "pinned": f"fused_blocks={fused}"}
    counted = counted_flops_per_step(cfg, images, labels, seed)
    if dev.type == "cuda":
        torch.cuda.reset_peak_memory_stats(dev)
    model = make_model(cfg, seed=seed, device=dev, fused_blocks=fused,
                       plain_kernels=plain_kernels)
    task = make_task(cfg, model)
    return Prepared(cfg, dev, loop_generation(dev), images, labels, fused, autotune_row,
                    calibration, counted, model, task, task.init())


def finish(p: Prepared, clock: StepClock, steps_per_record: int = 1,
           attribution: bool = True) -> Tuple[Optional[Dict[str, int]], Optional[Dict[str, Any]]]:
    """After the loop: the device's peak memory since :func:`prepare`
    (None on the CPU; also published as ``training_step_peak_hbm_bytes``)
    and, with ``attribution``, the ``attribution`` row (``attribute_resnet``
    over ``clock``, one clock record ``steps_per_record`` steps)."""
    mem = flops.memory_stats(p.device)
    record_step_peak_hbm(mem)
    if not attribution:
        return mem, None
    cfg = p.cfg
    return mem, attribution_row(
        lambda: attribute_resnet(batch=cfg.batch, image=cfg.image,
                                 num_classes=cfg.num_classes, stem=cfg.stem,
                                 fused_blocks=p.fused, generation=p.generation,
                                 stage_sizes=tuple(cfg.stage_sizes),
                                 num_filters=cfg.num_filters, device=p.device),
        clock, steps_per_record, generation=p.generation, device=p.device)


def train(cfg: ResNetBenchConfig, *, steps: int, seed: int = 0, device: DeviceLike = "cuda",
          fused_blocks: Union[None, bool, str] = None, plain_kernels: bool = False,
          on_step: Optional[Callable[[Dict[str, Any]], None]] = None,
          observe: Optional[Observer] = None,
          clock: Optional[StepClock] = None) -> Dict[str, Any]:
    """``steps`` SGD steps from seeded weights on one seeded batch, after
    :func:`prepare` (``fused_blocks`` and ``observe`` are its).

    Each step runs under a :class:`StepClock`: ``compute`` around the step
    and a device synchronize (``bench.py``'s ``block_until_ready``),
    ``fetch`` around the host read of its loss. Returns the per-step
    losses, accuracies and step times, the images per step, the step's
    counted FLOPs beside the bench's analytic count, ``mfu`` of the median
    step after the first (on the card; None on the CPU, which has no
    catalog peak), the ``step_breakdown``, ``peak_hbm_bytes`` of the
    training loop and the ``attribution`` row (:func:`finish`), the
    ``autotune`` row (and ``fused_calibration`` after a sweep). ``on_step``
    gets each step's record. ``clock``, if given, is the loop's clock (to
    register at ``/debug/profile`` or read after)."""
    clock = clock if clock is not None else StepClock(tracer=TRACER)
    p = prepare(cfg, steps=steps, clock=clock, seed=seed, device=device,
                fused_blocks=fused_blocks, plain_kernels=plain_kernels, observe=observe)
    state = p.state
    losses: List[float] = []
    accuracy: List[float] = []
    step_ms: List[float] = []
    clock.mark()
    for step in range(steps):
        with clock.compute():
            state, metrics = p.task.train_step(state, p.images, p.labels)
            synchronize(p.device)
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
    mem, attr = finish(p, clock)
    out = {"losses": losses, "accuracy": accuracy, "step_ms": step_ms,
           "images_per_step": cfg.batch, "flops_per_step": p.flops_per_step,
           "analytic_flops_per_step": flops_per_step(cfg.batch),
           "mfu": (flops.mfu(p.flops_per_step, steady_s, generation=p.generation)
                   if p.device.type == "cuda" else None),
           "step_breakdown": step_breakdown(clock),
           "peak_hbm_bytes": mem["peak_hbm_bytes"] if mem else None,
           "n_params": sum(q.numel() for q in p.model.parameters()),
           "fused_blocks": p.fused, "autotune": p.autotune}
    if p.calibration is not None:
        out["fused_calibration"] = p.calibration
    out["attribution"] = attr
    return out


def main(argv: Optional[List[str]] = None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--steps", type=int, default=8)
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--tiny", action="store_true",
                    help="a two-stage, 16-filter ResNet, batch 4 of 32 x 32 images "
                         "(for --device cpu)")
    ap.add_argument("--fused", choices=("auto", "true", "false"), default="auto",
                    help="auto (default) measures the fused kernel set against the "
                         "unfused model and trains with the faster, as bench.py's "
                         "BENCH_FUSED=auto; true/false pins it")
    args = ap.parse_args(argv)
    cfg = tiny_config() if args.tiny else bench_config()
    fused = {"auto": "auto", "true": True, "false": False}[args.fused]
    result = train(cfg, steps=args.steps, device=args.device, fused_blocks=fused,
                   on_step=lambda r: print(json.dumps(r), flush=True))
    keys = ("n_params", "flops_per_step", "analytic_flops_per_step", "mfu",
            "step_breakdown", "peak_hbm_bytes", "fused_blocks", "autotune",
            "fused_calibration", "attribution")
    print(json.dumps({k: result[k] for k in keys if k in result}), flush=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
