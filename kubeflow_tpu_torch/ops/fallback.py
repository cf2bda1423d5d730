"""Fused-kernel fallback visibility.

A copy of ``kubeflow_tpu/ops/fallback.py`` on the port's ``METRICS``. A
fused block whose input shape neither CUDA kernel takes runs the
epilogue-fused PyTorch path instead (``ops.fused_bottleneck.folded_bottleneck``);
that miss ticks ``ops_fused_fallback_total{kernel=...}`` and warns once per
(kernel, reason), so it shows in the metrics and not only in a profile.

PyTorch runs eagerly, so the counter counts every application of a block
that misses, where the JAX package counts once per traced shape.
"""

from __future__ import annotations

import warnings
from typing import Set, Tuple

from ..runtime.metrics import METRICS

_OPS = METRICS.namespace("ops")
_warned: Set[Tuple[str, str]] = set()


def record_fallback(kernel: str, reason: str) -> None:
    """Count a fused-kernel eligibility miss and warn once per reason."""
    _OPS.counter("fused_fallback_total", kernel=kernel).inc()
    key = (kernel, reason)
    if key not in _warned:
        _warned.add(key)
        warnings.warn(
            f"fused kernel {kernel!r} fell back to the PyTorch path: {reason} "
            "(counted in ops_fused_fallback_total)",
            RuntimeWarning, stacklevel=3)


def reset_fallback_warnings() -> None:
    """Re-arm the one-time warnings (tests)."""
    _warned.clear()
