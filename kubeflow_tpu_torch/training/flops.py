"""FLOP accounting and MFU for the port, from a counted step.

The port of ``kubeflow_tpu/training/flops.py``. In place of XLA's cost
analysis, :func:`counted_flops` runs a step once under
``torch.utils.flop_counter.FlopCounterMode``, which counts the products of
every matrix product and convolution (forward and backward; 2 FLOPs a
multiply-add) and nothing elementwise. Like XLA's cost analysis inside a
Pallas call, it sees nothing the port's ctypes kernels do, so a step is
counted the way ``bench.py`` counts it: ResNet-50 through its unfused
blocks (the same math), GPT with attention left out of the count
(:func:`uncounted`) and the causal attention dots added analytically.

Peaks come from the GPU catalog (:mod:`kubeflow_tpu_torch.gpu.topology`):
``mfu = flops_per_step / (step_seconds * num_chips * peak)``.
"""

from __future__ import annotations

from typing import Any, Callable, Dict, Optional

import torch

from ..device import DeviceLike, resolve_device
from ..gpu.topology import ACCELERATORS, lookup


def counted_flops(fn: Callable[..., Any], *args: Any, **kwargs: Any) -> int:
    """FLOPs of one call of ``fn(*args, **kwargs)``: it runs once under
    ``FlopCounterMode`` (side effects included) and the products of its
    matrix products and convolutions are summed."""
    from torch.utils.flop_counter import FlopCounterMode

    with FlopCounterMode(display=False) as counter:
        fn(*args, **kwargs)
    return int(counter.get_total_flops())


class _Uncounted(torch.autograd.Function):
    """``fn(*inputs)`` with its forward and backward hidden from any
    ``TorchDispatchMode`` (and so from ``FlopCounterMode``)."""

    @staticmethod
    def forward(ctx, fn, *inputs):
        from torch.utils._python_dispatch import _disable_current_modes

        with _disable_current_modes(), torch.enable_grad():
            leaves = [t.detach().requires_grad_(t.requires_grad) for t in inputs]
            out = fn(*leaves)
        ctx.graph = (leaves, out)
        return out.detach()

    @staticmethod
    def backward(ctx, grad):
        from torch.utils._python_dispatch import _disable_current_modes

        leaves, out = ctx.graph
        wanted = [t for t in leaves if t.requires_grad]
        with _disable_current_modes():
            grads = iter(torch.autograd.grad(out, wanted, grad))
        return (None, *[next(grads) if t.requires_grad else None for t in leaves])


def uncounted(fn: Callable[..., torch.Tensor]) -> Callable[..., torch.Tensor]:
    """``fn`` (tensors in, one tensor out) with its products, forward and
    backward, left out of :func:`counted_flops`: on the card the flash
    kernels are invisible to the counter anyway, and this makes the CPU's
    plain attention invisible the same way, so both count the same step."""
    def wrapped(*inputs: torch.Tensor) -> torch.Tensor:
        return _Uncounted.apply(fn, *inputs)
    return wrapped


def memory_stats(device: DeviceLike = "cuda") -> Optional[Dict[str, int]]:
    """Device memory of the process: ``peak_hbm_bytes``, the most PyTorch
    allocated at once since the last ``torch.cuda.reset_peak_memory_stats``.
    None on the CPU, which has no such counter."""
    dev = resolve_device(device)
    if dev.type != "cuda":
        return None
    return {"peak_hbm_bytes": int(torch.cuda.max_memory_allocated(dev))}


def peak_flops_per_chip(generation: str = "h100") -> float:
    return ACCELERATORS[generation].bf16_tflops_per_chip * 1e12


def peak_hbm_bandwidth(generation: str = "h100") -> float:
    """Peak HBM bytes/second per chip — the roofline's memory ceiling."""
    return ACCELERATORS[generation].hbm_gbps_per_chip * 1e9


def mfu(flops_per_step: float, step_seconds: float, num_chips: int = 1,
        generation: str = "h100") -> float:
    """Model FLOPs utilization in [0, 1]."""
    return flops_per_step / (step_seconds * num_chips * peak_flops_per_chip(generation))


def detect_generation(device: DeviceLike = "cuda") -> str:
    """The catalog generation of the CUDA card ``device``; raises on a CPU
    device and on a card the catalog does not list (its name in the
    message)."""
    dev = resolve_device(device)
    if dev.type != "cuda":
        raise RuntimeError(f"detect_generation: {dev} is not a CUDA device; peaks are "
                           "a card's")
    return lookup(torch.cuda.get_device_name(dev)).generation
