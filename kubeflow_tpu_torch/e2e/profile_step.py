"""Training-step decomposition: where the ResNet-50 step's time goes.

The port of ``e2e/profile_step.py``: ``ResNet50(num_classes=1000)`` (the
conv7x7 stem, unfused blocks) at batch 256 on 224 x 224 images, each line
isolating one subsystem:

  fwd_eval      forward only, BatchNorm in inference mode (no stats writes)
  fwd_train     forward with batch statistics (adds the normalization pass)
  fwd_bwd       + backward (the gradient convolutions dominate)
  full_step     + the SGD-momentum update over 25.6M parameters

The deltas between lines attribute time: (fwd_train - fwd_eval) ~ the
BatchNorm statistics, (fwd_bwd - fwd_train) ~ the backward, (full_step -
fwd_bwd) ~ the optimizer. Each line is
:func:`~kubeflow_tpu_torch.e2e.ceiling.timed` over back-to-back calls
(CUDA events after a warm-up call): eager PyTorch hoists nothing out of a
loop, so the JAX probe's anti-hoist carry has no counterpart.

Run on the card: ``python -m kubeflow_tpu_torch.e2e.profile_step
[--batch 256] [--steps 30]``.
"""

from __future__ import annotations

import argparse
import functools
import json
from typing import Any, Dict, List, Optional, Sequence

import torch

from ..device import DeviceLike, resolve_device
from ..models.resnet import BottleneckBlock, ResNet
from ..training.classifier import ClassifierTask, cross_entropy_loss, sgd_momentum
from .ceiling import timed


def profile(batch: int = 256, steps: int = 30, *, image: int = 224,
            stage_sizes: Sequence[int] = (3, 4, 6, 3), num_filters: int = 64,
            num_classes: int = 1000, device: DeviceLike = "cuda") -> Dict[str, Any]:
    """Seconds per call of each line (the defaults are ResNet-50's)."""
    dev = resolve_device(device)
    model = ResNet(stage_sizes, BottleneckBlock, num_classes=num_classes,
                   num_filters=num_filters, seed=0, device=dev)
    task = ClassifierTask(model, functools.partial(sgd_momentum, lr=0.1, total_steps=1000))
    g = torch.Generator(device=dev).manual_seed(0)
    images = torch.randn(batch, image, image, 3, generator=g, device=dev)
    labels = torch.randint(0, num_classes, (batch,), generator=g, device=dev)
    state = task.init()
    params = [p for p in model.parameters() if p.requires_grad]

    def fwd_eval():
        with torch.no_grad():
            return model(images, train=False)

    def fwd_train():
        with torch.no_grad():
            return model(images, train=True)

    def fwd_bwd():
        loss = cross_entropy_loss(model(images, train=True), labels)
        return torch.autograd.grad(loss, params)

    def full_step():
        return task.train_step(state, images, labels)

    rows = {name: timed(fn, steps, device=dev)
            for name, fn in (("fwd_eval", fwd_eval), ("fwd_train", fwd_train),
                             ("fwd_bwd", fwd_bwd), ("full_step", full_step))}
    return {"batch": batch, "seconds": rows}


def deltas(rows: Dict[str, float]) -> Dict[str, float]:
    """Seconds attributed to BatchNorm statistics, the backward and the
    optimizer."""
    return {"bn_stats": rows["fwd_train"] - rows["fwd_eval"],
            "backward": rows["fwd_bwd"] - rows["fwd_train"],
            "optimizer": rows["full_step"] - rows["fwd_bwd"]}


def main(argv: Optional[List[str]] = None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--batch", type=int, default=256)
    ap.add_argument("--steps", type=int, default=30)
    args = ap.parse_args(argv)
    out = profile(batch=args.batch, steps=args.steps)
    rows = out["seconds"]
    full = rows["full_step"]
    print(f"{'phase':12s} {'ms/step':>9s} {'of full':>8s}")
    for name, dt in rows.items():
        print(f"{name:12s} {dt * 1e3:8.1f}  {100 * dt / full:7.1f}%")
    for name, dt in deltas(rows).items():
        print(f"{'Δ ' + name:12s} {dt * 1e3:8.1f}  {100 * dt / full:7.1f}%")
    print(json.dumps({"metric": "resnet50_step_decomposition",
                      "device": torch.cuda.get_device_name(), **out}))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
