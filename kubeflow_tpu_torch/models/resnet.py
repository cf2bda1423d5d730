"""ResNet in PyTorch: the port of ``kubeflow_tpu/models/resnet.py``.

Same function and same variable tree as the flax model:

- NHWC activations at every public interface; inside, ``F.conv2d`` and
  ``F.max_pool2d`` take channels_last NCHW views, so no layout copy is made;
- ``dtype`` (bf16 by default) activations and convolutions, f32 parameters,
  f32 BatchNorm statistics, an f32 classifier head;
- the parameter names and layouts of flax (``stage1_block1.conv1.kernel``
  HWIO, ``bn1.scale``/``bias`` parameters and ``mean``/``var`` buffers,
  ``classifier.kernel [in, out]``), so ``models.convert.resnet_params_from_flax``
  maps one tree onto the other by name.

:class:`BatchNorm` is flax's, not ``torch.nn.BatchNorm2d``: statistics in
f32 with the biased variance ``E[x^2] - E[x]^2`` clipped at 0, and the
running update ``ra = 0.9 ra + 0.1 batch`` with that biased variance.

``fused_blocks=True`` routes every bottleneck through the CUDA kernels of
``ops.fused_bottleneck`` as the JAX model routes it through Pallas: identity
blocks to ``fused_bottleneck``, stage heads (stride 2, or a stride-1 channel
change) to ``fused_transition``, any other shape to ``folded_bottleneck``
with a counted fallback. Fused blocks normalize by the running statistics
folded into a scale and bias, in train mode too, and do not update them
("frozen norm"); their ``scale``/``bias`` parameters still get gradients
through the fold. ``plain_kernels=True`` runs the fused blocks through the
kernels' plain PyTorch versions on any device, the comparator the kernels
are held against.

Parameters are drawn at construction from a ``torch.Generator`` seeded with
``seed``, on the CPU, then moved to ``device``: lecun-normal (truncated)
kernels, ones and zeros for the norms, zero scale for each block's last
norm.
"""

from __future__ import annotations

from functools import partial
from typing import Optional, Sequence, Tuple, Type

import torch
import torch.nn as nn
import torch.nn.functional as F

from ..device import DeviceLike, resolve_device
from ..ops.fallback import record_fallback
from ..ops.fused_bottleneck import (conv_nhwc, folded_bottleneck, fused_bottleneck_block,
                                    fused_transition_block, maximum0)

Tensor = torch.Tensor
Pads = Optional[Sequence[Tuple[int, int]]]

#: the JAX model's ``nn.BatchNorm(momentum=0.9, epsilon=1e-5)``
BN_MOMENTUM, BN_EPSILON = 0.9, 1e-5


class Conv(nn.Module):
    """flax ``nn.Conv(use_bias=False)``'s tree: one f32 ``kernel`` [kh, kw,
    cin, cout]. Applied in ``dtype`` with SAME padding unless ``pads``."""

    def __init__(self, kh: int, kw: int, cin: int, cout: int) -> None:
        super().__init__()
        self.kernel = nn.Parameter(torch.empty(kh, kw, cin, cout))

    def forward(self, x: Tensor, dtype: torch.dtype, stride: int = 1, pads: Pads = None):
        return conv_nhwc(x.to(dtype), self.kernel.to(dtype), stride, pads)


class Dense(nn.Module):
    """flax ``nn.Dense`` in f32: ``kernel`` [in, out] and ``bias`` [out]."""

    def __init__(self, cin: int, cout: int) -> None:
        super().__init__()
        self.kernel = nn.Parameter(torch.empty(cin, cout))
        self.bias = nn.Parameter(torch.zeros(cout))

    def forward(self, x: Tensor) -> Tensor:
        return x @ self.kernel + self.bias


class BatchNorm(nn.Module):
    """flax ``nn.BatchNorm`` over the last axis, momentum 0.9, epsilon 1e-5.

    Train mode normalizes by the batch's f32 mean and biased variance
    (``E[x^2] - E[x]^2``, clipped at 0) and updates the running buffers
    in place; eval mode normalizes by the running buffers. The output has
    ``dtype``."""

    def __init__(self, features: int, dtype: torch.dtype, zero_scale: bool = False) -> None:
        super().__init__()
        self.dtype = dtype
        self.scale = nn.Parameter(torch.zeros(features) if zero_scale else torch.ones(features))
        self.bias = nn.Parameter(torch.zeros(features))
        self.register_buffer("mean", torch.zeros(features))
        self.register_buffer("var", torch.ones(features))

    def forward(self, x: Tensor, train: bool) -> Tensor:
        xf = x.float()
        if train:
            axes = tuple(range(x.dim() - 1))
            mean = xf.mean(axes)
            var = maximum0((xf * xf).mean(axes) - mean * mean)
            with torch.no_grad():
                self.mean.copy_(BN_MOMENTUM * self.mean + (1 - BN_MOMENTUM) * mean)
                self.var.copy_(BN_MOMENTUM * self.var + (1 - BN_MOMENTUM) * var)
        else:
            mean, var = self.mean, self.var
        mul = torch.rsqrt(var + BN_EPSILON) * self.scale
        return ((xf - mean) * mul + self.bias).to(self.dtype)

    def folded(self) -> Tuple[Tensor, Tensor]:
        """The eval-form norm as one affine ``y * s + b`` (``_FoldedNorm``):
        differentiable in ``scale`` and ``bias``, constant in the buffers."""
        inv = self.scale * torch.rsqrt(self.var + BN_EPSILON)
        return inv, self.bias - self.mean * inv


class BottleneckBlock(nn.Module):
    """1x1 -> 3x3 -> 1x1 bottleneck, with a projection shortcut when the
    channels or the stride change. ``fused`` picks the CUDA kernels as the
    JAX block picks Pallas (see the module docstring)."""

    def __init__(self, cin: int, filters: int, strides: Tuple[int, int] = (1, 1), *,
                 dtype: torch.dtype = torch.bfloat16, fused: bool = False,
                 plain_kernels: bool = False) -> None:
        super().__init__()
        self.filters, self.strides, self.dtype = filters, tuple(strides), dtype
        self.fused, self.plain_kernels = fused, plain_kernels
        cout = filters * 4
        self.conv1, self.bn1 = Conv(1, 1, cin, filters), BatchNorm(filters, dtype)
        self.conv2, self.bn2 = Conv(3, 3, filters, filters), BatchNorm(filters, dtype)
        # zero-init the last norm's scale: identity-ish residual at init
        self.conv3, self.bn3 = Conv(1, 1, filters, cout), BatchNorm(cout, dtype, zero_scale=True)
        self.has_proj = cin != cout or self.strides != (1, 1)
        if self.has_proj:
            self.conv_proj, self.bn_proj = Conv(1, 1, cin, cout), BatchNorm(cout, dtype)

    def _fusable(self, x: Tensor) -> bool:
        """Identity-shortcut kernel eligibility (stride 1, square)."""
        return (self.strides == (1, 1) and x.dim() == 4 and x.shape[-1] == self.filters * 4
                and x.shape[1] == x.shape[2] and x.shape[1] >= 4)

    def _fusable_transition(self, x: Tensor) -> bool:
        """Transition kernel eligibility: a stage head, square input, stride
        1 or 2; stride 2 needs an even spatial size (SAME pad (0, 1))."""
        if not (x.dim() == 4 and x.shape[1] == x.shape[2] and x.shape[1] >= 4):
            return False
        if self.strides == (1, 1):
            return x.shape[-1] != self.filters * 4
        return self.strides == (2, 2) and x.shape[1] % 2 == 0

    def _folded(self):
        s1, b1 = self.bn1.folded()
        s2, b2 = self.bn2.folded()
        s3, b3 = self.bn3.folded()
        main = (self.conv1.kernel[0, 0], s1, b1, self.conv2.kernel, s2, b2,
                self.conv3.kernel[0, 0], s3, b3)
        if not self.has_proj:
            return main, None
        return main, (self.conv_proj.kernel[0, 0], *self.bn_proj.folded())

    def forward(self, x: Tensor, train: bool = True) -> Tensor:
        if self.fused and self._fusable(x):
            main, _ = self._folded()
            return fused_bottleneck_block(x, *main, plain=self.plain_kernels)
        if self.fused and self._fusable_transition(x):
            main, proj = self._folded()
            return fused_transition_block(x, *main, *proj, stride=self.strides[0],
                                          plain=self.plain_kernels)
        if self.fused and x.dim() == 4:
            record_fallback(
                "fused_bottleneck",
                f"input shape {tuple(x.shape)} with strides {self.strides} is not "
                "kernel-fusable; using the epilogue-fused PyTorch path")
            main, proj = self._folded()
            return folded_bottleneck(x, *main, strides=self.strides, proj=proj)
        dt, stride = self.dtype, self.strides[0]
        y = torch.relu(self.bn1(self.conv1(x, dt), train))
        y = torch.relu(self.bn2(self.conv2(y, dt, stride), train))
        y = self.bn3(self.conv3(y, dt), train)
        residual = x
        if residual.shape != y.shape:
            residual = self.bn_proj(self.conv_proj(residual, dt, stride), train)
        return torch.relu(residual + y)


class BasicBlock(nn.Module):
    """Two 3x3 convolutions (ResNet-18/34); no fused kernel."""

    def __init__(self, cin: int, filters: int, strides: Tuple[int, int] = (1, 1), *,
                 dtype: torch.dtype = torch.bfloat16) -> None:
        super().__init__()
        self.strides, self.dtype = tuple(strides), dtype
        self.conv1, self.bn1 = Conv(3, 3, cin, filters), BatchNorm(filters, dtype)
        self.conv2, self.bn2 = Conv(3, 3, filters, filters), BatchNorm(filters, dtype,
                                                                       zero_scale=True)
        if cin != filters or self.strides != (1, 1):
            self.conv_proj, self.bn_proj = Conv(1, 1, cin, filters), BatchNorm(filters, dtype)

    def forward(self, x: Tensor, train: bool = True) -> Tensor:
        dt, stride = self.dtype, self.strides[0]
        y = torch.relu(self.bn1(self.conv1(x, dt, stride), train))
        y = self.bn2(self.conv2(y, dt), train)
        residual = x
        if residual.shape != y.shape:
            residual = self.bn_proj(self.conv_proj(residual, dt, stride), train)
        return torch.relu(residual + y)


def space_to_depth(x: Tensor, block: int = 2) -> Tensor:
    """[N, H, W, C] -> [N, H/b, W/b, b*b*C]: 2x2 pixel blocks folded into
    channels, as the JAX package orders them."""
    n, h, w, c = x.shape
    x = x.reshape(n, h // block, block, w // block, block, c).permute(0, 1, 3, 2, 4, 5)
    return x.reshape(n, h // block, w // block, block * block * c)


def lecun_normal_(t: Tensor, fan_in: int, generator: torch.Generator) -> None:
    """flax's ``lecun_normal``: a normal truncated at two standard
    deviations, scaled so that the variance is 1 / fan_in."""
    std = (1.0 / fan_in) ** 0.5 / 0.87962566103423978
    with torch.no_grad():
        nn.init.trunc_normal_(t, 0.0, 1.0, -2.0, 2.0, generator=generator).mul_(std)


class ResNet(nn.Module):
    """ResNet with flax's tree; ``forward(x [n, h, w, c], train)`` gives f32
    logits. ``stem="s2d"`` folds 2x2 space-to-depth into a 4x4 stride-1
    stem conv padded (2, 1) (``conv_init_s2d``, and the input's height and
    width must be even); ``"conv7x7"`` is the 7x7 stride-2 stem padded
    (3, 3) (``conv_init``); the input has 3 channels. ``fused_blocks``
    reaches bottleneck blocks only."""

    def __init__(self, stage_sizes: Sequence[int], block_cls: Type[nn.Module], *,
                 num_classes: int = 1000, num_filters: int = 64,
                 dtype: torch.dtype = torch.bfloat16, stem: str = "conv7x7",
                 fused_blocks: bool = False, plain_kernels: bool = False, seed: int = 0,
                 device: DeviceLike = "cuda") -> None:
        super().__init__()
        if stem not in ("s2d", "conv7x7"):
            raise ValueError(f"stem must be 's2d' or 'conv7x7', got {stem!r}")
        dev = resolve_device(device)
        self.stem, self.dtype = stem, dtype
        if stem == "s2d":
            self.conv_init_s2d = Conv(4, 4, 12, num_filters)
        else:
            self.conv_init = Conv(7, 7, 3, num_filters)
        self.bn_init = BatchNorm(num_filters, dtype)
        self.block_names = []
        cin = num_filters
        for i, count in enumerate(stage_sizes):
            filters = num_filters * 2 ** i
            for j in range(count):
                strides = (2, 2) if i > 0 and j == 0 else (1, 1)
                if block_cls is BottleneckBlock:
                    block = BottleneckBlock(cin, filters, strides, dtype=dtype,
                                            fused=fused_blocks, plain_kernels=plain_kernels)
                    cin = filters * 4
                else:
                    block = block_cls(cin, filters, strides, dtype=dtype)
                    cin = filters
                name = f"stage{i + 1}_block{j + 1}"
                self.add_module(name, block)
                self.block_names.append(name)
        self.classifier = Dense(cin, num_classes)
        self._init_params(seed)
        self.to(dev)

    def _init_params(self, seed: int) -> None:
        g = torch.Generator().manual_seed(seed)
        for module in self.modules():
            if isinstance(module, Conv):
                kh, kw, cin, _ = module.kernel.shape
                lecun_normal_(module.kernel, kh * kw * cin, g)
            elif isinstance(module, Dense):
                lecun_normal_(module.kernel, module.kernel.shape[0], g)

    @property
    def blocks(self):
        return [getattr(self, name) for name in self.block_names]

    def forward(self, x: Tensor, train: bool = True) -> Tensor:
        x = x.to(self.dtype)
        if self.stem == "s2d":
            if x.shape[1] % 2 or x.shape[2] % 2:
                raise ValueError(f"the s2d stem needs an even height and width, got "
                                 f"{tuple(x.shape)} (the JAX model then builds conv_init, "
                                 "another parameter tree)")
            x = self.conv_init_s2d(space_to_depth(x, 2), self.dtype, 1, ((2, 1), (2, 1)))
        else:
            x = self.conv_init(x, self.dtype, 2, ((3, 3), (3, 3)))
        x = torch.relu(self.bn_init(x, train))
        x = F.max_pool2d(x.permute(0, 3, 1, 2), 3, 2, padding=1).permute(0, 2, 3, 1)
        for block in self.blocks:
            x = block(x, train)
        # jnp.mean of a bf16 array sums in f32 and rounds back to bf16
        x = x.float().mean(dim=(1, 2)).to(self.dtype).float()
        return self.classifier(x)


ResNet18 = partial(ResNet, [2, 2, 2, 2], BasicBlock)
ResNet50 = partial(ResNet, [3, 4, 6, 3], BottleneckBlock)
ResNet101 = partial(ResNet, [3, 4, 23, 3], BottleneckBlock)
ResNet152 = partial(ResNet, [3, 8, 36, 3], BottleneckBlock)

