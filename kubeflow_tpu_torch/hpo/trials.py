"""Trial workloads, the objective functions StudyJobs optimize: the port
of ``kubeflow_tpu/hpo/trials.py``.

Each returns ``{metric: value}``. ``mnist_objective`` is a short real
training run of the port's ``MnistCNN`` through its ``ClassifierTask``;
the JAX control plane's ``InProcessTrialRunner`` calls it like JAX's
(``functools.partial(mnist_objective, device="cpu")`` on a host without
CUDA).
"""

from __future__ import annotations

import math
from typing import Any, Callable, Dict, Optional

import numpy as np
import torch

from ..device import DeviceLike, resolve_device
from ..models.mnist import MnistCNN
from ..training.classifier import ClassifierTask

ReportFn = Callable[[int, Dict[str, float]], Any]


def _adam(lr: float):
    """``optax.adam(lr)``'s defaults as a ``ClassifierTask`` optimizer."""
    return lambda params: (torch.optim.Adam(params, lr=lr, betas=(0.9, 0.999), eps=1e-8),
                           lambda _: lr)


def _train_trial(model: torch.nn.Module, images: torch.Tensor, labels: torch.Tensor, *,
                 lr: float, steps: int, report_fn: Optional[ReportFn] = None,
                 report_every: int = 5) -> Dict[str, float]:
    """``steps`` Adam steps of ``model`` on one batch; every
    ``report_every`` steps (while steps remain) ``report_fn(step,
    {"accuracy", "loss"})`` sees the last step's metrics and returning
    False stops the run. Returns the last step's metrics as floats."""
    task = ClassifierTask(model, _adam(lr))
    state = task.init()
    metrics: Dict[str, torch.Tensor] = {}
    for i in range(steps):
        state, metrics = task.train_step(state, images, labels)
        if report_fn is not None and (i + 1) % report_every == 0 and i + 1 < steps:
            cont = report_fn(i + 1, {"accuracy": float(metrics["accuracy"]),
                                     "loss": float(metrics["loss"])})
            if cont is False:
                break
    return {"accuracy": float(metrics["accuracy"]), "loss": float(metrics["loss"])}


def _trial_batch(batch: int, seed: int = 0):
    """Synthetic MNIST-shaped images [batch, 28, 28, 1] (seeded f32
    normals) and labels as JAX computes them from the images:
    ``(|x|.sum((1, 2, 3)) * 7) % 10``, so the task is learnable."""
    images = np.random.default_rng(seed).standard_normal((batch, 28, 28, 1), dtype=np.float32)
    labels = (np.abs(images).sum((1, 2, 3)) * 7).astype(np.int32) % 10
    return images, labels


def mnist_objective(params: Dict[str, Any], steps: int = 30, batch: int = 64,
                    report_fn: Optional[ReportFn] = None, report_every: int = 5,
                    device: DeviceLike = "cuda") -> Dict[str, float]:
    """Train ``MnistCNN`` (f32) briefly on synthetic data; returns the last
    step's accuracy and loss.

    Tunable params: lr (double), dropout (double), width (int); ``steps``
    in ``params`` overrides the argument. ``report_fn(step, {metric:
    value}) -> bool`` (optional) receives intermediate metrics every
    ``report_every`` steps; returning False stops the run early (median
    stopping) and the last metrics become the trial's result. The images
    come from numpy with seed 0 (JAX's ``jax.random.normal`` cannot be
    reproduced); the labels are JAX's function of them."""
    dev = resolve_device(device)
    lr = float(params.get("lr", 1e-3))
    dropout = float(params.get("dropout", 0.1))
    width = int(params.get("width", 16))
    steps = int(params.get("steps", steps))
    images, labels = _trial_batch(batch)
    model = MnistCNN(width=width, dropout_rate=dropout, dtype=torch.float32, seed=0,
                     device=dev)
    return _train_trial(model, torch.as_tensor(images, device=dev),
                        torch.as_tensor(labels, dtype=torch.int64, device=dev),
                        lr=lr, steps=steps, report_fn=report_fn, report_every=report_every)


def quadratic_objective(params: Dict[str, Any]) -> Dict[str, float]:
    """Cheap analytic objective for suggester and controller tests: its
    maximum is at lr=0.1, width=32."""
    lr = float(params.get("lr", 0.0))
    width = float(params.get("width", 0))
    score = math.exp(-((math.log10(max(lr, 1e-9)) + 1) ** 2)) * math.exp(
        -(((width - 32) / 32) ** 2))
    return {"accuracy": score}
