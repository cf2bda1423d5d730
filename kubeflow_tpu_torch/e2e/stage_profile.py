"""Per-stage ResNet-50 train-time decomposition: the port of
``e2e/stage_profile.py``.

The step-level profile (``e2e/profile_step.py``) attributes time to
forward, backward and optimizer but not to stages. This probe times each
stage as trained: one forward + backward (with respect to the parameters
and the input) over just that stage's blocks at its real activation shape,
BatchNorm in train mode, through the unfused ``BottleneckBlock`` (the
convolutions are cuDNN's: this measures them in context, it ports no
kernel). Each tower is :func:`~kubeflow_tpu_torch.e2e.ceiling.timed` over
back-to-back steps (CUDA events after a warm-up step): eager PyTorch
hoists nothing out of a loop, so the JAX probe's anti-hoist carry has no
counterpart. FLOPs are counted (``training.flops.counted_flops``: the
convolutions forward and backward), in place of XLA's cost analysis.

Output: ms and TF/s per stage and their sum.

Run on the card: ``python -m kubeflow_tpu_torch.e2e.stage_profile
[--batch 256] [--steps 20] [--stem conv7x7|s2d] [--norm train|eval|frozen]
[--stage SUBSTRING]``.
"""

from __future__ import annotations

import argparse
import json
from typing import Any, Dict, List, Optional, Sequence

import torch
import torch.nn as nn
import torch.nn.functional as F

from ..device import DeviceLike, resolve_device
from ..models.resnet import (BatchNorm, BottleneckBlock, Conv, lecun_normal_,
                             space_to_depth)
from ..training.flops import counted_flops
from .ceiling import timed


def _init_convs(module: nn.Module, seed: int) -> None:
    """flax's default conv init: lecun-normal kernels from a seeded
    generator, in module order."""
    g = torch.Generator().manual_seed(seed)
    for m in module.modules():
        if isinstance(m, Conv):
            kh, kw, cin, _ = m.kernel.shape
            lecun_normal_(m.kernel, kh * kw * cin, g)


class StemTower(nn.Module):
    """conv7x7/2 (or s2d) + BN + ReLU + maxpool, exactly as ResNet runs it
    (the names of flax's ``StemTower``: ``conv_init`` or ``conv_init_s2d``,
    ``bn_init``)."""

    def __init__(self, stem: str = "conv7x7", seed: int = 0,
                 device: DeviceLike = "cuda") -> None:
        super().__init__()
        if stem not in ("s2d", "conv7x7"):
            raise ValueError(f"stem must be 's2d' or 'conv7x7', got {stem!r}")
        self.stem = stem
        if stem == "s2d":
            self.conv_init_s2d = Conv(4, 4, 12, 64)
        else:
            self.conv_init = Conv(7, 7, 3, 64)
        self.bn_init = BatchNorm(64, torch.bfloat16)
        _init_convs(self, seed)
        self.to(resolve_device(device))

    def forward(self, x: torch.Tensor, train: bool = True) -> torch.Tensor:
        x = x.to(torch.bfloat16)
        if self.stem == "s2d":
            x = self.conv_init_s2d(space_to_depth(x, 2), torch.bfloat16, 1, ((2, 1), (2, 1)))
        else:
            x = self.conv_init(x, torch.bfloat16, 2, ((3, 3), (3, 3)))
        x = torch.relu(self.bn_init(x, train))
        return F.max_pool2d(x.permute(0, 3, 1, 2), 3, 2, padding=1).permute(0, 2, 3, 1)


class _ScaleBias(nn.Module):
    """BN stand-in: per-channel scale + bias with NO batch statistics (the
    'frozen' norm that isolates what the statistics' reductions cost)."""

    def __init__(self, features: int) -> None:
        super().__init__()
        self.scale = nn.Parameter(torch.ones(features))
        self.bias = nn.Parameter(torch.zeros(features))

    def forward(self, x: torch.Tensor, train: bool = True) -> torch.Tensor:
        return x * self.scale.to(x.dtype) + self.bias.to(x.dtype)


class StageTower(nn.Module):
    """One ResNet-50 bottleneck stage at its real shapes (blocks
    ``block1``..``blockN``, unfused).

    ``norm_mode``: 'train' = BN batch statistics (what training runs);
    'eval' = running-average BN (no statistics reduction); 'frozen' =
    scale + bias only (no reduction, no statistics traffic)."""

    def __init__(self, cin: int, filters: int, blocks: int, first_stride: int,
                 norm_mode: str = "train", seed: int = 0, device: DeviceLike = "cuda") -> None:
        super().__init__()
        if norm_mode not in ("train", "eval", "frozen"):
            raise ValueError(f"norm_mode must be train|eval|frozen, got {norm_mode!r}")
        self.norm_mode = norm_mode
        self.block_names = []
        for j in range(blocks):
            stride = first_stride if j == 0 else 1
            block = BottleneckBlock(cin, filters, (stride, stride), fused=False)
            if norm_mode == "frozen":
                for name in ("bn1", "bn2", "bn3", "bn_proj"):
                    if hasattr(block, name):
                        setattr(block, name, _ScaleBias(getattr(block, name).scale.shape[0]))
            name = f"block{j + 1}"
            self.add_module(name, block)
            self.block_names.append(name)
            cin = filters * 4
        _init_convs(self, seed)
        self.to(resolve_device(device))

    def forward(self, x: torch.Tensor, train: bool = True) -> torch.Tensor:
        train = train and self.norm_mode != "eval"
        x = x.to(torch.bfloat16)
        for name in self.block_names:
            x = getattr(self, name)(x, train)
        return x


def fwd_bwd(module: nn.Module, x: torch.Tensor):
    """One training step's work on ``module``: the forward in train mode,
    the loss ``sum(out) * 1e-6``, and its gradients with respect to every
    parameter and to ``x``. Returns (loss, grads)."""
    params = [p for p in module.parameters() if p.requires_grad]
    x = x.detach().requires_grad_(True)
    for p in params:
        p.grad = None
    loss = module(x, train=True).float().sum() * 1e-6
    loss.backward()
    return loss, [p.grad for p in params] + [x.grad]


def time_tower(module: nn.Module, x_shape: Sequence[int], steps: int,
               device: DeviceLike = "cuda") -> Dict[str, Any]:
    """ms a forward + backward step of ``module`` on f32 normals of
    ``x_shape`` (seed 0), its counted FLOPs (forward and backward) and TF/s."""
    dev = resolve_device(device)
    g = torch.Generator(device=dev).manual_seed(0)
    x = torch.randn(*x_shape, generator=g, device=dev)

    def step():
        loss, grads = fwd_bwd(module, x)
        # the gradients' sum, as the JAX body folds it into its carry
        return loss + sum(gr.float().sum() for gr in grads) * 1e-30

    flops = counted_flops(step)
    dt = timed(step, steps, device=dev)
    return {"ms": dt * 1e3, "tflops": flops / dt / 1e12 if flops else None,
            "gflops": flops / 1e9}


def towers(batch: int, stem: str = "conv7x7", norm: str = "train") -> List[tuple]:
    """(name, tower constructor, input shape) of the stem and the four
    stages at ``batch`` of 224 x 224; a constructor takes ``device``."""
    b = batch
    return [
        ("stem", lambda dev: StemTower(stem, device=dev), (b, 224, 224, 3)),
        ("stage1 (3x bottleneck 64, 56x56)",
         lambda dev: StageTower(64, 64, 3, 1, norm, device=dev), (b, 56, 56, 64)),
        ("stage2 (4x bottleneck 128, 28x28)",
         lambda dev: StageTower(256, 128, 4, 2, norm, device=dev), (b, 56, 56, 256)),
        ("stage3 (6x bottleneck 256, 14x14)",
         lambda dev: StageTower(512, 256, 6, 2, norm, device=dev), (b, 28, 28, 512)),
        ("stage4 (3x bottleneck 512, 7x7)",
         lambda dev: StageTower(1024, 512, 3, 2, norm, device=dev), (b, 14, 14, 1024)),
    ]


def profile(batch: int = 256, steps: int = 20, stem: str = "conv7x7", norm: str = "train",
            stages: Optional[Sequence[str]] = None,
            device: DeviceLike = "cuda") -> Dict[str, Any]:
    """Every tower (or those whose name contains one of ``stages``) timed;
    prints a line a tower and the sum. Returns the JSON line's dict."""
    rows: List[Dict[str, Any]] = []
    total_ms = 0.0
    for name, build, shape in towers(batch, stem, norm):
        if stages and not any(s in name for s in stages):
            continue
        r = {"stage": name, **time_tower(build(device), shape, steps, device=device)}
        rows.append(r)
        total_ms += r["ms"]
        rate = f"{r['tflops']:.1f} TF/s" if r["tflops"] else "n/a"
        print(f"{name:38s} {r['ms']:8.2f} ms  {r['gflops']:9.1f} GF  {rate}", flush=True)
    print(f"{'sum of stages (fwd+bwd, no opt/head)':38s} {total_ms:8.2f} ms")
    return {"metric": "resnet_stage_profile", "batch": batch, "stem": stem, "rows": rows,
            "sum_ms": round(total_ms, 2)}


def main(argv: Optional[List[str]] = None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--batch", type=int, default=256)
    ap.add_argument("--steps", type=int, default=20)
    ap.add_argument("--stem", default="conv7x7", choices=["conv7x7", "s2d"])
    ap.add_argument("--norm", default="train", choices=["train", "eval", "frozen"],
                    help="BN variant for the stage towers (isolates BN-stats cost)")
    ap.add_argument("--stage", action="append",
                    help="run only towers whose name contains this substring")
    args = ap.parse_args(argv)
    print(json.dumps(profile(args.batch, args.steps, args.stem, args.norm, args.stage)))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
