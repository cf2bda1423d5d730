"""MNIST CNN, the HPO trial workload: the port of
``kubeflow_tpu/models/mnist.py``.

Same function and same variable tree as the flax model, so
``models.convert.resnet_params_from_flax`` and ``resnet_params_to_flax``
carry it both ways:

- ``conv1`` (``width`` filters) and ``conv2`` (``2 * width``): 3 x 3, SAME
  padding (1 on each side), HWIO ``kernel`` and ``bias``; each followed by
  ``relu`` and a 2 x 2 average pool (VALID): 28 → 14 → 7;
- the NHWC activation flattened in (h, w, c) order, as flax flattens it;
- ``dense`` (128, ``kernel [in, out]``), ``relu``, dropout;
- ``classifier`` in f32.

Activations and dots in ``dtype`` (bf16 by default), f32 parameters drawn
at construction from a ``torch.Generator`` seeded with ``seed``:
lecun-normal (truncated) kernels and zero biases, as flax initializes
them. Dropout draws its masks from a generator on the model's device,
seeded with ``seed``: JAX's dropout RNG cannot be reproduced, so the two
packages agree in eval mode or with ``dropout_rate=0`` (ROADMAP.md C.4).
"""

from __future__ import annotations

import torch
import torch.nn as nn
import torch.nn.functional as F

from ..device import DeviceLike, resolve_device
from ..ops.fused_bottleneck import conv_nhwc
from .resnet import lecun_normal_

Tensor = torch.Tensor

#: MNIST's image side; two 2 x 2 pools leave 7 x 7
IMAGE = 28
DENSE = 128


class _Conv(nn.Module):
    """flax ``nn.Conv(features, (3, 3))``: HWIO ``kernel`` and ``bias``,
    SAME padding, applied in ``dtype``."""

    def __init__(self, cin: int, cout: int) -> None:
        super().__init__()
        self.kernel = nn.Parameter(torch.empty(3, 3, cin, cout))
        self.bias = nn.Parameter(torch.zeros(cout))

    def forward(self, x: Tensor, dtype: torch.dtype) -> Tensor:
        return conv_nhwc(x.to(dtype), self.kernel.to(dtype)) + self.bias.to(dtype)


class _Dense(nn.Module):
    """flax ``nn.Dense``: ``kernel [in, out]`` and ``bias``, applied in
    ``dtype``."""

    def __init__(self, cin: int, cout: int) -> None:
        super().__init__()
        self.kernel = nn.Parameter(torch.empty(cin, cout))
        self.bias = nn.Parameter(torch.zeros(cout))

    def forward(self, x: Tensor, dtype: torch.dtype) -> Tensor:
        return x.to(dtype) @ self.kernel.to(dtype) + self.bias.to(dtype)


def _avg_pool(x: Tensor) -> Tensor:
    """flax ``nn.avg_pool(x, (2, 2), strides=(2, 2))`` on NHWC."""
    return F.avg_pool2d(x.permute(0, 3, 1, 2), 2, 2).permute(0, 2, 3, 1)


class MnistCNN(nn.Module):
    """``forward(x [b, 28, 28, 1] NHWC, train=True)`` gives f32 logits."""

    def __init__(self, width: int = 32, dropout_rate: float = 0.1, num_classes: int = 10,
                 dtype: torch.dtype = torch.bfloat16, seed: int = 0,
                 device: DeviceLike = "cuda") -> None:
        super().__init__()
        dev = resolve_device(device)
        self.width, self.dropout_rate, self.dtype = width, float(dropout_rate), dtype
        self.conv1 = _Conv(1, width)
        self.conv2 = _Conv(width, 2 * width)
        self.dense = _Dense((IMAGE // 4) ** 2 * 2 * width, DENSE)
        self.classifier = _Dense(DENSE, num_classes)
        g = torch.Generator().manual_seed(seed)
        for conv in (self.conv1, self.conv2):
            kh, kw, cin, _ = conv.kernel.shape
            lecun_normal_(conv.kernel, kh * kw * cin, g)
        for dense in (self.dense, self.classifier):
            lecun_normal_(dense.kernel, dense.kernel.shape[0], g)
        self.to(dev)
        self._dropout_gen = torch.Generator(device=dev).manual_seed(seed)

    def _dropout(self, x: Tensor, train: bool) -> Tensor:
        """flax ``nn.Dropout``: identity when not training or at rate 0,
        else keep with probability ``1 - rate`` and scale by its inverse."""
        if not train or self.dropout_rate == 0.0:
            return x
        if self.dropout_rate == 1.0:
            return torch.zeros_like(x)
        keep_prob = 1.0 - self.dropout_rate
        keep = torch.rand(x.shape, generator=self._dropout_gen, device=x.device) < keep_prob
        return torch.where(keep, x / keep_prob, torch.zeros_like(x))

    def forward(self, x: Tensor, train: bool = True) -> Tensor:
        dt = self.dtype
        x = x.to(dt)
        x = _avg_pool(torch.relu(self.conv1(x, dt)))
        x = _avg_pool(torch.relu(self.conv2(x, dt)))
        x = x.reshape(x.shape[0], -1)  # (h, w, c) order, as flax flattens NHWC
        x = self._dropout(torch.relu(self.dense(x, dt)), train)
        return self.classifier(x.float(), torch.float32)
