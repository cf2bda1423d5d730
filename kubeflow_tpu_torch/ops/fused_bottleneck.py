"""Fused ResNet bottleneck blocks (1x1 -> 3x3 -> 1x1 + shortcut).

The port of ``kubeflow_tpu/ops/fused_bottleneck.py``. Two hand-written
CUDA kernels (``csrc/fused_bottleneck.cu``) replace the Pallas ones:

- ``fused_bottleneck`` — the identity-shortcut, stride-1 block:
  ``y = relu(x + bn3(conv1x1(relu(bn2(conv3x3(relu(bn1(conv1x1(x)))))))))``;
- ``fused_transition`` — the stage head: a stride-1 or stride-2 3x3 and a
  1x1 projection shortcut on ``x[::s, ::s]``,
  ``y = relu(bnp(conv1x1_s(x)) + bn3(...))``.

Layouts are the JAX package's: x is NHWC ``[n, hw, hw, cin]``, ``w1 [cin,
cmid]``, ``w2 [3, 3, cmid, cmid]`` (HWIO), ``w3 [cmid, cout]``, ``wp [cin,
cout]``; each norm is a folded f32 ``(scale, bias)`` pair of ``[c]``.
Numerics are the Pallas kernels': every dot takes bf16 operands (x, the
weights, and h1 and h2 after their rounding to bf16) with f32 sums; the
affine, relu, residual and projection run in f32; the output takes x's
dtype (bf16 or f32). The 3x3 uses XLA's SAME padding: (1, 1) at stride 1,
(0, 1) at stride 2 on an even input.

:func:`fused_bottleneck_block` and :func:`fused_transition_block` are
differentiable through :class:`FusedBottleneckBlock` and
:class:`FusedTransitionBlock`, the ``torch.autograd.Function`` s in place of
JAX's ``custom_vjp`` s: the forward is the kernel, and the backward
recomputes the all-f32 composite (:func:`_composite_f32`,
:func:`_transition_composite_f32`) from the saved primal inputs under
autograd and returns every cotangent cast to its primal's dtype. The JAX
package has no backward kernel for these blocks, and neither has the port.
The recompute runs with TF32 off in cuDNN and cuBLAS, so that it is f32 as
the JAX package's is.

For bf16 x both blocks run the shared-memory kernels
(``fused_bottleneck_kernel_mma``, ``fused_transition_kernel_mma``): the
weights and the x rows (the reduce's, and the projection's x[::s, ::s])
staged in shared memory by ``cp.async``, fragments by ``ldmatrix``, 64 x 64
warp tiles on ``mma.sync`` (64 x 32 for each of the projection phase's two
GEMMs), bands from :func:`plan_band_mma`. f32 x runs the first kernels,
which load their operands straight into registers (bands from
:func:`plan_band`).

A wrapper takes the plain PyTorch versions (:func:`fused_bottleneck_plain`,
:func:`fused_transition_plain`: the same bf16 roundings, f32 convolutions)
only when x lies on the CPU; on a CUDA tensor it launches the kernel or
raises. ``plain=True`` on the ``*_block`` functions runs the plain versions
on any device, the comparator the kernels are held against. Each kernel
launch adds one to ``LAUNCHES[<name>]``.
"""

from __future__ import annotations

import contextlib
import functools
from typing import Dict, Iterator, Optional, Sequence, Tuple

import torch
import torch.nn.functional as F

from . import _build

SOURCE = "fused_bottleneck.cu"

#: kernel launches per kernel since the last :func:`reset_launches`
LAUNCHES: Dict[str, int] = {"fused_bottleneck": 0, "fused_transition": 0}

#: shared memory a block may take on an H100 (227 KB), and the most that
#: still lets two 256-thread blocks share one SM
SMEM_MAX = 232448
SMEM_TWO_PER_SM = 113 * 1024

Tensor = torch.Tensor


def reset_launches() -> None:
    for k in LAUNCHES:
        LAUNCHES[k] = 0


# -- shapes and padding ---------------------------------------------------------

def same_pads(size: int, kernel: int, stride: int) -> Tuple[int, int]:
    """XLA's SAME padding (lo, hi) of one spatial axis: the output has
    ceil(size / stride) positions and the odd pad goes on the high side."""
    out = -(-size // stride)
    total = max((out - 1) * stride + kernel - size, 0)
    return total // 2, total - total // 2


def conv_nhwc(x: Tensor, w: Tensor, stride: int = 1,
              pads: Optional[Sequence[Tuple[int, int]]] = None) -> Tensor:
    """``lax.conv_general_dilated(x, w, stride, pads, ("NHWC", "HWIO",
    "NHWC"))`` through ``F.conv2d``: x is handed over as a channels_last
    NCHW view, the padding is explicit (``F.pad``; SAME when ``pads`` is
    None), and the result comes back as an NHWC view. No dtype is changed."""
    kh, kw = w.shape[:2]
    if pads is None:
        pads = (same_pads(x.shape[1], kh, stride), same_pads(x.shape[2], kw, stride))
    xc = x.permute(0, 3, 1, 2)
    (top, bottom), (left, right) = pads
    if top or bottom or left or right:
        xc = F.pad(xc, (left, right, top, bottom))
    y = F.conv2d(xc, w.permute(3, 2, 0, 1), stride=stride)
    return y.permute(0, 2, 3, 1)


def _check(x: Tensor, w1: Tensor, w2: Tensor, w3: Tensor,
           wp: Optional[Tensor], stride: int) -> Tuple[int, int, int, int]:
    """(hw, cin, cmid, cout) of a block's inputs; raises on shapes the
    kernels do not take."""
    if x.dim() != 4 or x.shape[1] != x.shape[2]:
        raise ValueError(f"fused block: x must be [n, hw, hw, cin], got {tuple(x.shape)}")
    _, hw, _, cin = x.shape
    cmid, cout = w1.shape[1], w3.shape[1]
    want = {"w1": (cin, cmid), "w2": (3, 3, cmid, cmid), "w3": (cmid, cout)}
    got = {"w1": tuple(w1.shape), "w2": tuple(w2.shape), "w3": tuple(w3.shape)}
    if wp is not None:
        want["wp"], got["wp"] = (cin, cout), tuple(wp.shape)
    elif cout != cin:
        raise ValueError(f"fused_bottleneck: identity shortcut needs cout == cin, "
                         f"got {cout} != {cin}")
    if got != want:
        raise ValueError(f"fused block: weight shapes {got} do not fit x "
                         f"{tuple(x.shape)} (want {want})")
    if stride not in (1, 2):
        raise ValueError(f"fused_transition: stride must be 1 or 2, got {stride}")
    if stride == 2 and hw % 2:
        raise ValueError(f"fused_transition: stride 2 needs an even hw, got {hw} "
                         "(its SAME padding is then (0, 1))")
    return hw, cin, cmid, cout


# -- plain versions and composites ----------------------------------------------

def _bf16(t: Tensor) -> Tensor:
    """f32 copy of a dot operand rounded to bf16 (``astype(dot_dtype)``)."""
    return t.to(torch.bfloat16).float()


def _plain(x, w1, s1, b1, w2, s2, b2, w3, s3, b3, proj, stride):
    xb = _bf16(x)
    h1 = torch.relu(xb @ _bf16(w1) * s1 + b1)
    h2 = conv_nhwc(_bf16(h1), _bf16(w2), stride)
    h2 = torch.relu(h2 * s2 + b2)
    y = _bf16(h2) @ _bf16(w3) * s3 + b3
    if proj is None:
        return torch.relu(y + x.float()).to(x.dtype)
    wp, sp, bp = proj
    shortcut = xb[:, ::stride, ::stride] @ _bf16(wp) * sp + bp
    return torch.relu(shortcut + y).to(x.dtype)


def fused_bottleneck_plain(x, w1, scale1, bias1, w2, scale2, bias2,
                           w3, scale3, bias3) -> Tensor:
    """Plain version of the ``fused_bottleneck`` kernel on any device: x,
    h1, h2 and the weights rounded to bf16 where the kernel rounds them,
    f32 products and sums."""
    _check(x, w1, w2, w3, None, 1)
    return _plain(x, w1, scale1, bias1, w2, scale2, bias2, w3, scale3, bias3, None, 1)


def fused_transition_plain(x, w1, scale1, bias1, w2, scale2, bias2,
                           w3, scale3, bias3, wp, scalep, biasp, *,
                           stride: int = 2) -> Tensor:
    """Plain version of the ``fused_transition`` kernel on any device."""
    _check(x, w1, w2, w3, wp, stride)
    return _plain(x, w1, scale1, bias1, w2, scale2, bias2, w3, scale3, bias3,
                  (wp, scalep, biasp), stride)


def maximum0(t: Tensor) -> Tensor:
    """``jnp.maximum(t, 0.0)``: its gradient at a tie, t == 0, is split
    evenly (1/2), as ``torch.maximum``'s is; ``torch.relu``'s is 0 there.
    Ties are common: a block whose last norm scale is zero passes relu'd
    activations, many of them exactly 0, straight to the final maximum."""
    return torch.maximum(t, t.new_zeros(()))


def _folded_f32(x, w1, s1, b1, w2, s2, b2, w3, s3, b3, proj, stride):
    """The block in f32 with SAME convolutions and no bf16 rounding."""
    h1 = maximum0(conv_nhwc(x, w1[None, None]) * s1 + b1)
    h2 = maximum0(conv_nhwc(h1, w2, stride) * s2 + b2)
    y = conv_nhwc(h2, w3[None, None]) * s3 + b3
    if proj is None:
        return maximum0(y + x)
    wp, sp, bp = proj
    return maximum0(conv_nhwc(x, wp[None, None], stride) * sp + bp + y)


def _composite_f32(x, w1, scale1, bias1, w2, scale2, bias2, w3, scale3, bias3):
    """All-f32 twin of the identity block, the backward's recompute target
    (``_composite_f32`` of the JAX package)."""
    return _folded_f32(x, w1, scale1, bias1, w2, scale2, bias2, w3, scale3, bias3,
                       None, 1)


def _transition_composite_f32(stride, x, w1, scale1, bias1, w2, scale2, bias2,
                              w3, scale3, bias3, wp, scalep, biasp):
    """All-f32 twin of the transition block (``_transition_composite_f32``)."""
    return _folded_f32(x, w1, scale1, bias1, w2, scale2, bias2, w3, scale3, bias3,
                       (wp, scalep, biasp), stride)


def folded_bottleneck(x, w1, scale1, bias1, w2, scale2, bias2, w3, scale3, bias3,
                      *, strides: Tuple[int, int] = (1, 1), proj=None) -> Tensor:
    """The PyTorch path for block shapes neither kernel takes: the same
    folded-norm math in f32 with SAME convolutions, cast back to x's dtype.
    ``proj`` is ``(wp, scalep, biasp)`` for a projection shortcut, or None."""
    if strides[0] != strides[1]:
        raise ValueError(f"folded_bottleneck: strides must be equal, got {strides}")
    f32 = [t.float() for t in (x, w1, w2, w3)]
    proj32 = None if proj is None else (proj[0].float(), proj[1], proj[2])
    out = _folded_f32(f32[0], f32[1], scale1, bias1, f32[2], scale2, bias2, f32[3],
                      scale3, bias3, proj32, strides[0])
    return out.to(x.dtype)


def reference_bottleneck(x, w1, scale1, bias1, w2, scale2, bias2, w3, scale3, bias3):
    """The composite the kernel must match, as the JAX package names it."""
    return fused_bottleneck_plain(x, w1, scale1, bias1, w2, scale2, bias2,
                                  w3, scale3, bias3)


def reference_transition(x, w1, scale1, bias1, w2, scale2, bias2, w3, scale3, bias3,
                         wp, scalep, biasp, *, stride: int = 2):
    """The composite the transition kernel must match."""
    return fused_transition_plain(x, w1, scale1, bias1, w2, scale2, bias2, w3,
                                  scale3, bias3, wp, scalep, biasp, stride=stride)


# -- kernels ---------------------------------------------------------------------

def smem_bytes(hw: int, stride: int, cmid: int, band: int) -> int:
    """Shared memory of one kernel block: h1 for the band's 3x3 taps (with
    its zero border) and h2 for the band, bf16, pixel rows padded by 8."""
    ho = hw // stride
    rows, cols = (band + 2, hw + 2) if stride == 1 else (2 * band + 1, hw + 1)
    return (rows * cols + band * ho) * (cmid + 8) * 2


@functools.lru_cache(maxsize=None)
def plan_band(hw: int, stride: int, cin: int, cmid: int, cout: int, proj: bool) -> int:
    """Output rows per block of the register-load kernels (f32 x; the last
    band of an image may be shorter): the band whose blocks do the least
    tensor-core work — h1's halo rows are recomputed by both neighbours,
    and each warp's pixel tile is padded to 16 — among those whose shared
    memory fits; a block too large for two per SM counts 1.3 times (half
    the warps per SM to hide latency; the factor is a guess, not a
    measurement)."""
    ho = hw // stride
    pad16 = lambda m: -(-m // 16) * 16  # noqa: E731
    per_pixel = 9 * cmid * cmid + cmid * cout + (cin * cout if proj else 0)

    def block_cost(i0: int, rows: int) -> int:
        row0, held = (i0 - 1, rows + 2) if stride == 1 else (2 * i0, 2 * rows + 1)
        h1_rows = min(row0 + held, hw) - max(row0, 0)
        return pad16(h1_rows * hw) * cin * cmid + pad16(rows * ho) * per_pixel

    best = None
    for band in range(1, ho + 1):
        smem = smem_bytes(hw, stride, cmid, band)
        if smem > SMEM_MAX:
            continue
        cost = sum(block_cost(i0, min(band, ho - i0)) for i0 in range(0, ho, band))
        if smem > SMEM_TWO_PER_SM:
            cost *= 1.3
        if best is None or cost < best[0]:
            best = (cost, band)
    if best is None:
        raise ValueError(f"fused block: hw {hw}, cmid {cmid} needs more than "
                         f"{SMEM_MAX} bytes of shared memory for one output row")
    return best[1]


#: the bf16 kernels (``fused_bottleneck_kernel_mma``,
#: ``fused_transition_kernel_mma``): warps a block, m16 tiles and channels a
#: warp holds (32 in the transition's phase 3, which holds two sets of
#: sums), k-chunks in the ring, and the most rows of a 64-deep chunk (a
#: chunk of more rows is 32 deep)
MMA_WARPS, MMA_WARP_TILES, MMA_WARP_CHANNELS, MMA_STAGES, MMA_KC_ROWS = 8, 4, 64, 2, 256
MMA_DUAL_CHANNELS = 32


def _warps_n(n: int, width: int = MMA_WARP_CHANNELS) -> int:
    """Warps along the channels for a phase of ``n`` output channels,
    ``width`` a warp (the source's ``warps_n``): the largest power of two
    up to 8 whose slices ``n`` fills."""
    w = 1
    while w * 2 <= MMA_WARPS and w * 2 * width <= n:
        w *= 2
    return w


def _chunk_rows(n: int, width: int = MMA_WARP_CHANNELS, wn: Optional[int] = None) -> int:
    """Weight rows of a phase's staged k-chunk: ``wn`` (by default
    :func:`_warps_n`'s) warps of ``width`` channels."""
    return min(n, (wn or _warps_n(n, width)) * width)


def _sweeps(m: int, wn: int) -> int:
    """Sweeps over ``m`` pixels with ``wn`` warps along N (``sweeps``)."""
    return -(-m // (MMA_WARPS // wn * MMA_WARP_TILES * 16))


#: the weights of a phase worth fitting its warps to its pixels (the
#: source's FIT_WEIGHTS): below it, the x rows re-staged by the extra
#: channel passes outweigh the weights a sweep saves
FIT_WEIGHTS = 128 * 1024


def _phase_warps_n(m: int, n: int, width: int, fit_m: bool) -> int:
    """Warps along N for a phase of ``m`` pixels by ``n`` channels (the
    source's ``phase_warps_n``): :func:`_warps_n`, and for the transition
    (``fit_m``) then halved while that saves a sweep over the pixels, since
    every sweep re-reads the phase's weights."""
    wn = _warps_n(n, width)
    while fit_m and wn > 1 and _sweeps(m, wn // 2) < _sweeps(m, wn):
        wn //= 2
    return wn


def _chunk_depth(rows: int, kc_rows: int = MMA_KC_ROWS) -> int:
    """Depth of a staged k-chunk of ``rows`` rows (``chunk_depth``): 64, a
    whole 128-byte line of each bf16 weight row, up to ``kc_rows`` rows,
    else 32."""
    return 64 if rows <= kc_rows else 32


def _h1_rows(band: int, stride: int) -> int:
    """Image rows of a block's h1 tile: the band and a halo row each side
    (stride 1), or rows 2 i0 .. 2 i0 + 2 band (stride 2)."""
    return band + 2 if stride == 1 else 2 * band + 1


def mma_layout(hw: int, cmid: int, cout: int, band: int, stride: int = 1,
               proj: bool = False, choices: Optional[Tuple[int, bool]] = None,
               cin: Optional[int] = None) -> Dict[str, int]:
    """The source's ``MmaLayout``: the warps along N (``wn1``..``wn3``) and
    chunk depth (``kc1``..``kc3``) of each phase, the layout choices
    (``kc_rows``, ``fit1``; by default :func:`mma_choices`') and the bytes
    of the three regions of a block's shared memory: the h1 tile with its
    zero border (in phase 3, the warps' f32 epilogue staging and, for the
    projection, its ring of x chunks); h2 (in phase 1, the ring of x
    chunks); the ring of weight chunks. Rows are padded by 8 bf16 values.
    ``cin`` defaults to ``cout`` (the identity block's)."""
    cin = cin or cout
    kc_rows, fit1 = choices or mma_choices(hw, cmid, cout, band, stride, proj, cin)
    ho, hr = hw // stride, _h1_rows(band, stride)
    wc = hw + 2 if stride == 1 else hw + 1
    w3 = MMA_DUAL_CHANNELS if proj else MMA_WARP_CHANNELS
    lda, m1, m2 = cmid + 8, min(hr, hw) * hw, band * ho
    # each phase's weights: cin cmid, 9 cmid cmid, and (cmid + cin) cout
    wn1 = _phase_warps_n(m1, cmid, 64, proj and fit1 and cin * cmid >= FIT_WEIGHTS)
    wn2 = _phase_warps_n(m2, cmid, 64, proj and 9 * cmid * cmid >= FIT_WEIGHTS)
    wn3 = _phase_warps_n(m2, cout, w3, proj and (cmid + cin) * cout >= FIT_WEIGHTS)
    xrows = min(MMA_WARPS // wn1 * MMA_WARP_TILES, -(-m1 // 16)) * 16
    xrows3 = min(MMA_WARPS // wn3 * MMA_WARP_TILES, -(-m2 // 16)) * 16 if proj else 0
    r1, r2, r3 = _chunk_rows(cmid, 64, wn1), _chunk_rows(cmid, 64, wn2), _chunk_rows(cout, w3, wn3)
    kc1, kc2 = _chunk_depth(max(r1, xrows), kc_rows), _chunk_depth(r2, kc_rows)
    kc3 = _chunk_depth(max(r3, xrows3), kc_rows)
    bstride = max(r1 * (kc1 + 8), r2 * (kc2 + 8), r3 * (kc3 + 8))
    staging = MMA_WARPS * 16 * (MMA_WARP_CHANNELS + 4) * 4
    region1 = max(hr * wc * lda * 2, staging + MMA_STAGES * xrows3 * (kc3 + 8) * 2)
    region2 = max(band * ho * lda * 2, MMA_STAGES * xrows * (kc1 + 8) * 2)
    return dict(wn1=wn1, wn2=wn2, wn3=wn3, kc1=kc1, kc2=kc2, kc3=kc3, kc_rows=kc_rows,
                fit1=fit1, region1=region1, region2=region2, region3=MMA_STAGES * bstride * 2)


def smem_bytes_mma(hw: int, cmid: int, cout: int, band: int, stride: int = 1,
                   proj: bool = False, choices: Optional[Tuple[int, bool]] = None,
                   cin: Optional[int] = None) -> int:
    """Shared memory of one block of the bf16 kernels."""
    lay = mma_layout(hw, cmid, cout, band, stride, proj, choices, cin)
    return lay["region1"] + lay["region2"] + lay["region3"]


def mma_choices(hw: int, cmid: int, cout: int, band: int, stride: int = 1,
                proj: bool = False, cin: Optional[int] = None) -> Tuple[int, bool]:
    """The layout choices of a launch (the source's ``mma_choices``): the
    most rows of a 64-deep chunk, and whether phase 1's warps are fitted to
    its pixels. The identity block takes ``(MMA_KC_ROWS, False)``; the
    transition the first of these that fits: chunks 64 deep up to
    ``MMA_KC_ROWS`` rows, then up to half that (leaving room for a deeper
    band), each with phase 1's warps fitted (which widens phase 1's ring of
    x chunks), then not."""
    if not proj:
        return MMA_KC_ROWS, False
    for choice in ((MMA_KC_ROWS, True), (MMA_KC_ROWS, False), (MMA_KC_ROWS // 2, True),
                   (MMA_KC_ROWS // 2, False)):
        if smem_bytes_mma(hw, cmid, cout, band, stride, proj, choice, cin) <= SMEM_MAX:
            return choice
    return MMA_KC_ROWS // 2, False


def mma_sweeps(m: int, n: int, width: int = MMA_WARP_CHANNELS,
               wn: Optional[int] = None) -> list:
    """How the bf16 kernels cover a phase of ``m`` pixels by ``n`` channels
    with ``wn`` (by default :func:`_warps_n`'s) warps along N of ``width``
    channels: one (first m16 tile, m16 tiles) pair per warp along M for each
    sweep. Each sweep is computed once for each chunk of ``wn * width``
    channels."""
    wm = MMA_WARPS // (wn or _warps_n(n, width))
    tiles, per, out = -(-m // 16), wm * MMA_WARP_TILES, []
    for t0 in range(0, tiles, per):
        ts = min(per, tiles - t0)
        tpw = -(-ts // wm)
        out.append([(t0 + i * tpw, max(0, min(tpw, t0 + ts - (t0 + i * tpw))))
                    for i in range(wm)])
    return out


#: the plan's weights of a staged byte and of a warp's mma in one k-chunk,
#: and of a k-chunk itself (its barrier and wait), set so that the model
#: picks the band that ran fastest on an H100 at each ResNet-50 shape
#: (``e2e/fused_block_sweep.py``; PERF.md)
_NS_PER_BYTE, _NS_PER_MMA, _NS_PER_CHUNK = 1 / 23, 6, 400


def _phase_ns(m: int, n: int, gemms: Sequence[Tuple[int, int, bool]], kc: int, wn: int,
              width: int = MMA_WARP_CHANNELS) -> float:
    """Modelled ns of one block-wide phase of ``m`` pixels by ``n`` channels,
    ``wn`` warps along N of ``width`` channels each, whose GEMMs ``gemms``
    are (k, taps, x staged): each k-chunk of a (sweep, channel chunk) pass
    costs its staged bytes (weights, and staged x rows), its longest warp's
    mma and a fixed cost."""
    rows, ns = _chunk_rows(n, width, wn), 0.0
    for sweep in mma_sweeps(m, n, width, wn):
        tpw = max(mt for _, mt in sweep)
        pixels = sum(mt for _, mt in sweep) * 16
        for n0 in range(0, n, wn * width):
            nt = min(width // 8, (n - n0) // 8)
            for k, taps, staged in gemms:
                per_chunk = ((min(rows, n - n0) + (pixels if staged else 0)) * kc * 2
                             * _NS_PER_BYTE + tpw * nt * kc // 16 * _NS_PER_MMA
                             + _NS_PER_CHUNK)
                ns += -(-k // kc) * taps * per_chunk
    return ns


def mma_band_ns(hw: int, cin: int, cmid: int, cout: int, band: int, stride: int = 1,
                proj: bool = False) -> float:
    """Modelled ns of all of one image's blocks at ``band`` rows a block
    (:func:`_phase_ns` of each phase): h1's halo rows are recomputed by
    both neighbouring bands, and every block re-reads all the weights."""
    ho, lay, ns = hw // stride, mma_layout(hw, cmid, cout, band, stride, proj, cin=cin), 0.0
    w3 = MMA_DUAL_CHANNELS if proj else MMA_WARP_CHANNELS
    gemms3 = [(cmid, 1, False)] + ([(cin, 1, True)] if proj else [])
    for i0 in range(0, ho, band):
        rows = min(band, ho - i0)
        row0 = i0 - 1 if stride == 1 else 2 * i0
        m1 = (min(row0 + _h1_rows(rows, stride), hw) - max(row0, 0)) * hw
        ns += (_phase_ns(m1, cmid, [(cin, 1, True)], lay["kc1"], lay["wn1"])
               + _phase_ns(rows * ho, cmid, [(cmid, 9, False)], lay["kc2"], lay["wn2"])
               + _phase_ns(rows * ho, cout, gemms3, lay["kc3"], lay["wn3"], w3))
    return ns


def mma_bands(hw: int, cmid: int, cout: int, stride: int = 1, proj: bool = False,
              cin: Optional[int] = None) -> list:
    """The bands whose block fits the card's shared memory."""
    return [band for band in range(1, hw // stride + 1)
            if smem_bytes_mma(hw, cmid, cout, band, stride, proj, cin=cin) <= SMEM_MAX]


@functools.lru_cache(maxsize=None)
def plan_band_mma(hw: int, cin: int, cmid: int, cout: int, stride: int = 1,
                  proj: bool = False) -> int:
    """Output rows per block of the bf16 kernels (the last band of an image
    may be shorter): of the bands that fit, the one of least
    :func:`mma_band_ns`. ``proj``: the transition, stride 1 or 2."""
    bands = mma_bands(hw, cmid, cout, stride, proj, cin)
    if not bands:
        raise ValueError(f"fused block: hw {hw}, cmid {cmid} needs more than "
                         f"{SMEM_MAX} bytes of shared memory for one output row")
    return min(bands, key=lambda b: mma_band_ns(hw, cin, cmid, cout, b, stride, proj))


def plan_for(dtype: torch.dtype, hw: int, stride: int, cin: int, cmid: int, cout: int,
             proj: bool) -> int:
    """The band a launch takes: :func:`plan_band_mma` for bf16 x (the
    shared-memory kernels), :func:`plan_band` for f32 x. Channel counts are
    the padded ones (multiples of 16)."""
    if dtype == torch.bfloat16:
        return plan_band_mma(hw, cin, cmid, cout, stride, proj)
    return plan_band(hw, stride, cin, cmid, cout, proj)


def _pad_to(t: Tensor, sizes: Sequence[int]) -> Tensor:
    """``t`` zero-padded at the end of each axis to ``sizes``."""
    pad = []
    for have, want in reversed(list(zip(t.shape, sizes))):
        pad += [0, want - have]
    return F.pad(t, pad) if any(pad) else t


def _launch(name: str, x: Tensor, main: Sequence[Tensor],
            proj: Optional[Sequence[Tensor]], stride: int,
            band: Optional[int] = None) -> Tensor:
    """Run kernel ``name`` on CUDA tensors, with ``band`` output rows a
    block (by default the plan's). Channel counts that are not multiples of
    16 (the mma depth) are zero-padded here and the output sliced back: zero
    weights, scales and biases keep the padded channels at zero. ResNet-50's
    channels need no padding."""
    if x.device.type != "cuda":
        raise ValueError(f"{name}: x must lie on the CPU (plain version) or on a "
                         f"CUDA device, got {x.device}")
    if x.dtype not in (torch.bfloat16, torch.float32):
        raise ValueError(f"{name}: the kernel takes bf16 or f32 x, got {x.dtype}")
    for t in (*main, *(proj or ())):
        if t.device != x.device:
            raise ValueError(f"{name}: all tensors must be on {x.device}, got one on {t.device}")
    w1, s1, b1, w2, s2, b2, w3, s3, b3 = main
    n, hw, _, cin = x.shape
    cmid, cout = w1.shape[1], w3.shape[1]
    up = lambda c: -(-c // 16) * 16  # noqa: E731
    ci, cm, co = up(cin), up(cmid), up(cout)

    def bf16_t(w: Tensor, shape: Sequence[int]) -> Tensor:
        """A weight rounded to bf16 once per call, [out, in] for the mma B operand."""
        w = _pad_to(w.detach().to(torch.bfloat16), shape)
        return w.reshape(-1, shape[-1]).t().contiguous()

    def f32(t: Tensor, c: int) -> Tensor:
        return _pad_to(t.detach().float(), (c,)).contiguous()

    # every tensor whose pointer the kernel reads stays referenced here
    # until the launch is queued
    tensors = [_pad_to(x.detach(), (n, hw, hw, ci)).contiguous(),
               bf16_t(w1, (ci, cm)), f32(s1, cm), f32(b1, cm),
               bf16_t(w2, (3, 3, cm, cm)), f32(s2, cm), f32(b2, cm),
               bf16_t(w3, (cm, co)), f32(s3, co), f32(b3, co)]
    if proj is not None:
        wp, sp, bp = proj
        tensors += [bf16_t(wp, (ci, co)), f32(sp, co), f32(bp, co)]
    ho = hw // stride
    out = torch.empty((n, ho, ho, co), dtype=x.dtype, device=x.device)
    if band is None:
        band = plan_for(x.dtype, hw, stride, ci, cm, co, proj is not None)
    dims = (n, hw, ci, cm, co, stride) if proj is not None else (n, hw, ci, cm)
    stream = torch.cuda.current_stream(x.device).cuda_stream
    rc = _build.entry(SOURCE, name)(x.device.index, *[t.data_ptr() for t in tensors],
                                    out.data_ptr(), int(x.dtype == torch.bfloat16),
                                    *dims, band, stream)
    LAUNCHES[name] += 1
    if rc != 0:
        raise RuntimeError(f"{name}: CUDA launch failed with cudaError {rc}")
    return out if co == cout else out[..., :cout].contiguous()


def fused_bottleneck(x, w1, scale1, bias1, w2, scale2, bias2, w3, scale3, bias3) -> Tensor:
    """The identity-shortcut block through the ``fused_bottleneck`` kernel;
    the plain version for a CPU x. Replaces the Pallas ``_kernel`` of
    ``kubeflow_tpu/ops/fused_bottleneck.py``."""
    if x.device.type == "cpu":
        return fused_bottleneck_plain(x, w1, scale1, bias1, w2, scale2, bias2,
                                      w3, scale3, bias3)
    _check(x, w1, w2, w3, None, 1)
    return _launch("fused_bottleneck", x,
                   (w1, scale1, bias1, w2, scale2, bias2, w3, scale3, bias3), None, 1)


def fused_transition(x, w1, scale1, bias1, w2, scale2, bias2, w3, scale3, bias3,
                     wp, scalep, biasp, *, stride: int = 2) -> Tensor:
    """The stage-head block through the ``fused_transition`` kernel; the
    plain version for a CPU x. Replaces the Pallas ``_transition_kernel``.
    ``stride`` is 1 or 2; stride 2 needs an even hw."""
    if x.device.type == "cpu":
        return fused_transition_plain(x, w1, scale1, bias1, w2, scale2, bias2, w3,
                                      scale3, bias3, wp, scalep, biasp, stride=stride)
    _check(x, w1, w2, w3, wp, stride)
    return _launch("fused_transition", x,
                   (w1, scale1, bias1, w2, scale2, bias2, w3, scale3, bias3),
                   (wp, scalep, biasp), stride)


# -- autograd ----------------------------------------------------------------------

@contextlib.contextmanager
def f32_convolutions() -> Iterator[None]:
    """TF32 off in cuDNN and cuBLAS for the block (restored after).
    ``torch.backends.cudnn.flags(allow_tf32=False)`` is not used: its other
    arguments default to turning cuDNN off."""
    saved = torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    try:
        yield
    finally:
        torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32 = saved


def _composite_vjp(fn, primals: Sequence[Tensor], g: Tensor) -> Tuple[Tensor, ...]:
    """Cotangents of ``fn`` at the f32 primals for the output cotangent
    ``g``, each cast to its primal's dtype (``_fused_block_bwd``)."""
    with torch.enable_grad(), f32_convolutions():
        p32 = [t.detach().float().requires_grad_(True) for t in primals]
        grads = torch.autograd.grad(fn(*p32), p32, g.float())
    return tuple(d.to(t.dtype) for d, t in zip(grads, primals))


class FusedBottleneckBlock(torch.autograd.Function):
    """``custom_vjp`` of ``fused_bottleneck_block``: the kernel forward
    (the plain version when ``plain``), the f32 composite backward.
    Residuals are the primal inputs only."""

    @staticmethod
    def forward(ctx, x, w1, s1, b1, w2, s2, b2, w3, s3, b3, plain: bool):
        ctx.save_for_backward(x, w1, s1, b1, w2, s2, b2, w3, s3, b3)
        fwd = fused_bottleneck_plain if plain else fused_bottleneck
        return fwd(x, w1, s1, b1, w2, s2, b2, w3, s3, b3)

    @staticmethod
    def backward(ctx, g):
        return (*_composite_vjp(_composite_f32, ctx.saved_tensors, g), None)


class FusedTransitionBlock(torch.autograd.Function):
    """``custom_vjp`` of ``_transition_block``, as
    :class:`FusedBottleneckBlock` with the projection shortcut."""

    @staticmethod
    def forward(ctx, x, w1, s1, b1, w2, s2, b2, w3, s3, b3, wp, sp, bp,
                stride: int, plain: bool):
        ctx.save_for_backward(x, w1, s1, b1, w2, s2, b2, w3, s3, b3, wp, sp, bp)
        ctx.stride = stride
        fwd = fused_transition_plain if plain else fused_transition
        return fwd(x, w1, s1, b1, w2, s2, b2, w3, s3, b3, wp, sp, bp, stride=stride)

    @staticmethod
    def backward(ctx, g):
        stride = ctx.stride
        grads = _composite_vjp(lambda *p: _transition_composite_f32(stride, *p),
                               ctx.saved_tensors, g)
        return (*grads, None, None)


def fused_bottleneck_block(x, w1, scale1, bias1, w2, scale2, bias2, w3, scale3, bias3,
                           *, plain: bool = False) -> Tensor:
    """Differentiable fused identity block: kernel forward, f32 composite
    backward. ``plain=True`` runs the plain version on any device."""
    return FusedBottleneckBlock.apply(x, w1, scale1, bias1, w2, scale2, bias2,
                                      w3, scale3, bias3, bool(plain))


def fused_transition_block(x, w1, scale1, bias1, w2, scale2, bias2, w3, scale3, bias3,
                           wp, scalep, biasp, *, stride: int = 2,
                           plain: bool = False) -> Tensor:
    """Differentiable fused transition block (same contract as
    :func:`fused_bottleneck_block`)."""
    return FusedTransitionBlock.apply(x, w1, scale1, bias1, w2, scale2, bias2, w3,
                                      scale3, bias3, wp, scalep, biasp, int(stride),
                                      bool(plain))
