"""Convolution-ceiling experiments: the port of ``e2e/conv_experiments.py``.

The stage-1 3x3 convolution (batch 256, 56x56, 64->64, bf16) is
[M = 256*56*56 = 802816, K = 9*64 = 576] @ [K, N = 64] as a GEMM. These
probes measure that same arithmetic in every formulation a kernel could
choose, on the card's libraries (``torch.matmul`` is cuBLAS and
``F.conv2d`` cuDNN: they are what is measured here, no kernel is ported):

1. ``gemm_conv_style``    — [M, 576] @ [576, 64], output channels minor;
2. ``gemm_spatial_lanes`` — [64, 576] @ [576, M], the transposed
   orientation; same FLOPs;
3. ``gemm_tap_dots``      — 9 x ([64, 64] @ [64, M]) summed in f32, the
   no-im2col variant (one product a 3x3 tap, contraction 64);
4. ``conv_xla``           — the convolution itself at the stage shape;
5. ``conv_xla_fused``     — convolution + BN-apply + ReLU;
6. ``conv_stem`` / ``conv_stem_s2d`` — the 7x7/2 stem on 224x224x3 against
   its space-to-depth form (112x112x12, 4x4/1);
7. ``conv_grad_*`` / ``conv1x1_grad_*`` — forward + gradient with respect
   to the input, the weights or both, at the 3x3 and 1x1 shapes;
8. ``bottleneck_block_fwd_bwd`` — the whole stage-1 bottleneck with a
   frozen scale/bias norm, forward + backward.

The probe names, shapes, FLOP formulas and the ``CHAIN``/``ITERS``
structure are JAX's. Each probe's body is a chain of ``CHAIN`` dependent
steps whose output feeds the next, carried from call to call as the JAX
scan carries it; :func:`~kubeflow_tpu_torch.e2e.ceiling.timed` runs
``ITERS`` calls between CUDA events (after one warm-up call), and a row's
``iter_s`` is the seconds of one chain step. Tensors are NHWC as in JAX,
handed to ``F.conv2d`` as channels-last NCHW views (no layout copy).

Run on the card: ``python -m kubeflow_tpu_torch.e2e.conv_experiments
[--probe NAME]`` (``CEILING_ITERS``, default 20, sets ``ITERS``).
"""

from __future__ import annotations

import argparse
import json
import os
from typing import Any, Callable, Dict, List, Optional

import torch
import torch.nn.functional as F

from ..device import DeviceLike, resolve_device
from ..ops.fused_bottleneck import same_pads
from .ceiling import CHAIN, timed

ITERS = int(os.environ.get("CEILING_ITERS", "20"))

# Stage-1 conv3x3 as GEMM
B, HW, C = 256, 56, 64
M = B * HW * HW          # 802816
K = 9 * C                # 576

Probe = Callable[..., Dict[str, Any]]


def _normal(*shape: int, dev: torch.device) -> torch.Tensor:
    g = torch.Generator(device=dev).manual_seed(0)
    return torch.randn(*shape, generator=g, device=dev, dtype=torch.bfloat16)


def conv_nhwc(x: torch.Tensor, k: torch.Tensor, stride: int = 1) -> torch.Tensor:
    """``lax.conv_general_dilated(x, k, (stride, stride), "SAME")`` with
    NHWC ``x`` and HWIO ``k``, through ``F.conv2d`` on channels-last views.
    A symmetric SAME pad is the convolution's own ``padding`` (no extra
    pass over x, as XLA pads inside the convolution); an odd one (the
    extra row and column after) goes through ``F.pad``."""
    (pt, pb), (pl, pr) = (same_pads(x.shape[1], k.shape[0], stride),
                          same_pads(x.shape[2], k.shape[1], stride))
    xc, w = x.permute(0, 3, 1, 2), k.permute(3, 2, 0, 1)
    if pt == pb and pl == pr:
        y = F.conv2d(xc, w, stride=stride, padding=(pt, pl))
    else:
        y = F.conv2d(F.pad(xc, (pl, pr, pt, pb)), w, stride=stride)
    return y.permute(0, 2, 3, 1)


def _run(body: Callable[[torch.Tensor], torch.Tensor], x0: torch.Tensor, dev: torch.device,
         iters: int, chain: int) -> float:
    """Seconds a chain step: ``body`` applied ``chain`` times a call to the
    carried tensor, ``iters`` timed calls."""
    state = {"x": x0}

    def call():
        x = state["x"]
        for _ in range(chain):
            x = body(x)
        state["x"] = x
        return x

    return timed(call, iters, device=dev) / chain


def gemm_step(x: torch.Tensor, w: torch.Tensor, proj: torch.Tensor) -> torch.Tensor:
    """One chain step of ``_gemm_probe``: x <- |(x @ w) @ proj| * 0.05, the
    second product folding the result back into x's shape."""
    return torch.abs((x @ w) @ proj) * 0.05


def gemm_flops(m: int, k: int, n: int) -> float:
    return 2.0 * m * k * n * 2  # two dots per chain step


def _gemm_probe(m: int, k: int, n: int, name: str, *, iters: int = ITERS,
                chain: int = CHAIN, device: DeviceLike = "cuda") -> Dict[str, Any]:
    dev = resolve_device(device)
    x = _normal(m, k, dev=dev) * 0.05
    w = _normal(k, n, dev=dev) * 0.05
    proj = _normal(n, k, dev=dev) * 0.05
    dt = _run(lambda x: gemm_step(x, w, proj), x, dev, iters, chain)
    return {"kernel": name, "tflops": gemm_flops(m, k, n) / dt / 1e12, "iter_s": dt}


def gemm_conv_style(**kw: Any) -> Dict[str, Any]:
    return _gemm_probe(M, K, C, f"gemm[{M}x{K}]@[{K}x{C}] (cout in lanes)", **kw)


def gemm_spatial_lanes(**kw: Any) -> Dict[str, Any]:
    return _gemm_probe(C, K, M, f"gemm[{C}x{K}]@[{K}x{M}] (spatial in lanes)", **kw)


def tap_dots_step(x: torch.Tensor, w9: torch.Tensor) -> torch.Tensor:
    """One chain step of ``gemm_tap_dots``: sum over the 9 taps of
    ``w9[t].T @ x`` in f32, then ``|y|`` in x's dtype, times 0.05. Each
    product leaves the GEMM in x's dtype before the f32 sum (JAX asks its
    dots for f32 out)."""
    y = torch.zeros(x.shape, dtype=torch.float32, device=x.device)
    for t in range(9):
        y = y + (w9[t].T @ x).float()
    return torch.abs(y).to(x.dtype) * 0.05


def tap_dots_flops(c: int = C, m: int = M) -> float:
    return 2.0 * c * c * m * 9


def gemm_tap_dots(*, iters: int = ITERS, chain: int = CHAIN, c: int = C, m: int = M,
                  device: DeviceLike = "cuda") -> Dict[str, Any]:
    """9 tap-products of K = 64: w9[9, 64, 64] x x[64, M] -> summed [64, M]."""
    dev = resolve_device(device)
    x = _normal(c, m, dev=dev) * 0.05
    w9 = _normal(9, c, c, dev=dev) * 0.05
    dt = _run(lambda x: tap_dots_step(x, w9), x, dev, iters, chain)
    return {"kernel": f"9 tap-dots [{c}x{c}]@[{c}xM] (K={c})",
            "tflops": tap_dots_flops(c, m) / dt / 1e12, "iter_s": dt}


def conv_step(x: torch.Tensor, k: torch.Tensor, proj: torch.Tensor, scale: torch.Tensor,
              bias: torch.Tensor, stride: int, hw: int, fuse_bn_relu: bool) -> torch.Tensor:
    """One chain step of ``_conv_probe``: the convolution (and BN-apply +
    ReLU), a 1x1 projection back to ``cin`` channels scaled by 1/hw,
    repeated back to ``hw`` when strided, ``|.|`` in x's dtype."""
    y = conv_nhwc(x, k, stride)
    if fuse_bn_relu:
        y = torch.clamp_min(y * scale + bias, 0.0)
    z = conv_nhwc(y, proj) * (1.0 / hw)
    if stride != 1:
        z = z.repeat_interleave(stride, 1).repeat_interleave(stride, 2)  # back to hw
    return torch.abs(z).to(x.dtype)


def conv_flops(batch: int, hw: int, cin: int, cout: int, ksz: int, stride: int) -> float:
    ohw = hw // stride
    return 2.0 * batch * ohw * ohw * (ksz * ksz * cin * cout + cout * cin)


def _conv_probe(batch: int, hw: int, cin: int, cout: int, ksz: int, stride: int,
                name: str, fuse_bn_relu: bool = False, *, iters: int = ITERS,
                chain: int = CHAIN, device: DeviceLike = "cuda") -> Dict[str, Any]:
    dev = resolve_device(device)
    x0 = _normal(batch, hw, hw, cin, dev=dev)
    k = _normal(ksz, ksz, cin, cout, dev=dev) * 0.05
    proj = _normal(1, 1, cout, cin, dev=dev) * 0.05
    scale = _normal(cout, dev=dev) * 0.1
    bias = _normal(cout, dev=dev) * 0.1
    dt = _run(lambda x: conv_step(x, k, proj, scale, bias, stride, hw, fuse_bn_relu),
              x0, dev, iters, chain)
    flops = conv_flops(batch, hw, cin, cout, ksz, stride)
    return {"kernel": name, "tflops": flops / dt / 1e12, "iter_s": dt}


def conv_xla(**kw: Any) -> Dict[str, Any]:
    return _conv_probe(B, HW, C, C, 3, 1, f"conv3x3 b{B} {HW}x{HW}x{C}->{C} (XLA)", **kw)


def conv_xla_fused(**kw: Any) -> Dict[str, Any]:
    return _conv_probe(B, HW, C, C, 3, 1,
                       f"conv3x3+bn+relu b{B} {HW}x{HW}x{C}->{C} (XLA)", fuse_bn_relu=True,
                       **kw)


def conv_stem(**kw: Any) -> Dict[str, Any]:
    # 7x7/2 on 224x224x3: K = 49*3 = 147 contraction from 3 input channels
    return _conv_probe(B, 224, 3, 64, 7, 2, f"stem conv7x7/2 b{B} 224x224x3->64 (XLA)", **kw)


def conv_stem_s2d(**kw: Any) -> Dict[str, Any]:
    # space-to-depth: [224, 224, 3] -> [112, 112, 12]; the 7x7/2 stem becomes
    # a 4x4/1 convolution on the repacked grid (16*12 = 192 taps against 147)
    return _conv_probe(B, 112, 12, 64, 4, 1, f"stem-s2d conv4x4 b{B} 112x112x12->64 (XLA)",
                       **kw)


def _abs_sum_loss(y: torch.Tensor) -> torch.Tensor:
    return y.float().abs().sum()


def conv_grad_step(x: torch.Tensor, k: torch.Tensor, which: str) -> torch.Tensor:
    """One chain step of ``_conv_bwd_probe``: the loss ``sum(|conv(x, k)|)``
    and its gradient with respect to x ('x'), k ('w') or both, folded into
    the next x as the JAX body folds it."""
    xv = x.detach().requires_grad_(which in ("x", "both"))
    kv = k.detach().requires_grad_(which in ("w", "both"))
    loss = _abs_sum_loss(conv_nhwc(xv, kv))
    tiny = torch.tensor(1e-30, dtype=x.dtype, device=x.device)
    if which == "x":
        (dx,) = torch.autograd.grad(loss, [xv])
        return (torch.abs(dx) * 0.01).to(x.dtype)
    if which == "w":
        (dw,) = torch.autograd.grad(loss, [kv])
        # dw is tiny [3, 3, cin, cin]; keep it live through x
        return x * (1.0 + torch.sum(torch.abs(dw)) * tiny)
    dx, dw = torch.autograd.grad(loss, [xv, kv])
    return (torch.abs(dx) * 0.01 + torch.sum(torch.abs(dw)) * tiny).to(x.dtype)


def conv_grad_flops(which: str, cin: int = C, hw: int = HW, batch: int = B) -> float:
    conv_f = 2.0 * batch * hw * hw * 9 * cin * cin
    return conv_f * (3.0 if which == "both" else 2.0)  # fwd + 1-2 grad convs


def _conv_bwd_probe(which: str, cin: int = C, hw: int = HW, *, batch: int = B,
                    iters: int = ITERS, chain: int = CHAIN,
                    device: DeviceLike = "cuda") -> Dict[str, Any]:
    """Backward decomposition at the stage-1 3x3 shape: fwd + grad wrt x
    ('x'), wrt w ('w'), or both. The loss is sum(|conv|), so dY depends on
    x; the gradients feed the next chain step, so nothing is dead."""
    dev = resolve_device(device)
    x0 = _normal(batch, hw, hw, cin, dev=dev)
    k0 = _normal(3, 3, cin, cin, dev=dev) * 0.05
    dt = _run(lambda x: conv_grad_step(x, k0, which), x0, dev, iters, chain)
    return {"kernel": f"conv3x3 {hw}x{hw}x{cin} fwd+grad_{which}",
            "tflops": conv_grad_flops(which, cin, hw, batch) / dt / 1e12, "iter_s": dt}


def conv1x1_flops(cin: int, cout: int, hw: int = HW, batch: int = B) -> float:
    return 3.0 * 2.0 * batch * hw * hw * cin * cout


def _conv1x1_bwd_probe(cin: int, cout: int, hw: int = HW, *, batch: int = B,
                       iters: int = ITERS, chain: int = CHAIN,
                       device: DeviceLike = "cuda") -> Dict[str, Any]:
    """fwd+bwd of the bottleneck's 1x1 convolutions (projection GEMMs)."""
    dev = resolve_device(device)
    x0 = _normal(batch, hw, hw, cin, dev=dev)
    k0 = _normal(1, 1, cin, cout, dev=dev) * 0.05
    dt = _run(lambda x: conv_grad_step(x, k0, "both"), x0, dev, iters, chain)
    return {"kernel": f"conv1x1 {hw}x{hw} {cin}->{cout} fwd+grad_both",
            "tflops": conv1x1_flops(cin, cout, hw, batch) / dt / 1e12, "iter_s": dt}


def conv1x1_grad_reduce(**kw: Any) -> Dict[str, Any]:
    return _conv1x1_bwd_probe(256, 64, **kw)


def conv1x1_grad_expand(**kw: Any) -> Dict[str, Any]:
    return _conv1x1_bwd_probe(64, 256, **kw)


def block_params(cin: int = 256, cmid: int = 64, dev: torch.device = torch.device("cpu")):
    """The bottleneck probe's weights: three HWIO kernels (normals * 0.05)
    and frozen scale/bias pairs (ones, zeros), bf16."""
    ones, zeros = (lambda n: torch.ones(n, dtype=torch.bfloat16, device=dev),
                   lambda n: torch.zeros(n, dtype=torch.bfloat16, device=dev))
    return {
        "k1": _normal(1, 1, cin, cmid, dev=dev) * 0.05,
        "k2": _normal(3, 3, cmid, cmid, dev=dev) * 0.05,
        "k3": _normal(1, 1, cmid, cin, dev=dev) * 0.05,
        "s1": ones(cmid), "b1": zeros(cmid), "s2": ones(cmid), "b2": zeros(cmid),
        "s3": ones(cin), "b3": zeros(cin),
    }


def block(x: torch.Tensor, p: Dict[str, torch.Tensor]) -> torch.Tensor:
    """1x1 -> 3x3 -> 1x1 with frozen scale/bias norms, ReLUs and the
    identity residual."""
    y = torch.clamp_min(conv_nhwc(x, p["k1"]) * p["s1"] + p["b1"], 0)
    y = torch.clamp_min(conv_nhwc(y, p["k2"]) * p["s2"] + p["b2"], 0)
    y = conv_nhwc(y, p["k3"]) * p["s3"] + p["b3"]
    return torch.clamp_min(x + y, 0)


def block_step(x: torch.Tensor, p: Dict[str, torch.Tensor]) -> torch.Tensor:
    """One chain step: grads of ``sum(|block(x, p)|)`` with respect to x
    and every weight, folded into the next x."""
    xv = x.detach().requires_grad_(True)
    leaves = {k: v.detach().requires_grad_(True) for k, v in p.items()}
    loss = _abs_sum_loss(block(xv, leaves))
    grads = torch.autograd.grad(loss, [xv, *leaves.values()])
    dpsum = sum(torch.sum(torch.abs(g)) for g in grads[1:])
    tiny = torch.tensor(1e-30, dtype=x.dtype, device=x.device)
    return (torch.abs(grads[0]) * 0.05 + dpsum * tiny).to(x.dtype)


def block_flops(cin: int = 256, cmid: int = 64, hw: int = HW, batch: int = B) -> float:
    conv_f = 2.0 * batch * hw * hw * (cin * cmid + 9 * cmid * cmid + cmid * cin)
    return 3.0 * conv_f  # fwd + dX + dW


def bottleneck_block_fwd_bwd(*, batch: int = B, hw: int = HW, iters: int = ITERS,
                             chain: int = CHAIN, device: DeviceLike = "cuda") -> Dict[str, Any]:
    """The whole stage-1 bottleneck (1x1 256->64, 3x3 64->64, 1x1 64->256,
    ReLUs and the residual; frozen scale/bias norm) forward + backward."""
    dev = resolve_device(device)
    x0 = _normal(batch, hw, hw, 256, dev=dev) * 0.1
    p = block_params(dev=dev)
    dt = _run(lambda x: block_step(x, p), x0, dev, iters, chain)
    return {"kernel": "bottleneck(256->64->64->256) fwd+bwd frozen-norm",
            "tflops": block_flops(hw=hw, batch=batch) / dt / 1e12, "iter_s": dt}


def conv_grad_x(**kw: Any) -> Dict[str, Any]:
    return _conv_bwd_probe("x", **kw)


def conv_grad_w(**kw: Any) -> Dict[str, Any]:
    return _conv_bwd_probe("w", **kw)


def conv_grad_both(**kw: Any) -> Dict[str, Any]:
    return _conv_bwd_probe("both", **kw)


def conv_grad_both_128(**kw: Any) -> Dict[str, Any]:
    return _conv_bwd_probe("both", cin=128, hw=28, **kw)


PROBES: Dict[str, Probe] = {
    "gemm_conv_style": gemm_conv_style,
    "gemm_spatial_lanes": gemm_spatial_lanes,
    "gemm_tap_dots": gemm_tap_dots,
    "conv_xla": conv_xla,
    "conv_xla_fused": conv_xla_fused,
    "conv_stem": conv_stem,
    "conv_stem_s2d": conv_stem_s2d,
    "conv_grad_x": conv_grad_x,
    "conv_grad_w": conv_grad_w,
    "conv_grad_both": conv_grad_both,
    "conv_grad_both_128": conv_grad_both_128,
    "conv1x1_grad_reduce": conv1x1_grad_reduce,
    "conv1x1_grad_expand": conv1x1_grad_expand,
    "bottleneck_block_fwd_bwd": bottleneck_block_fwd_bwd,
}


def run_probes(names: Optional[List[str]] = None, **kw: Any) -> List[Dict[str, Any]]:
    """Each probe's row, printed as it lands; a failing probe's row
    records its error (``tflops`` 0.0) and the sweep goes on, as JAX's."""
    rows: List[Dict[str, Any]] = []
    for name in names or list(PROBES):
        try:
            r = PROBES[name](**kw)
        except Exception as e:  # record, keep sweeping
            r = {"kernel": name, "tflops": 0.0, "error": str(e)[:160]}
        rows.append(r)
        print(f"{r['kernel']:55s} {r['tflops']:9.1f} TF/s"
              + (f"  ERROR {r['error']}" if r.get("error") else ""), flush=True)
    return rows


def main(argv: Optional[List[str]] = None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--probe", choices=sorted(PROBES), action="append",
                    help="run only these probes (default: all)")
    args = ap.parse_args(argv)
    rows = run_probes(args.probe)
    print(json.dumps({"metric": "conv_experiments", "rows": rows}))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
