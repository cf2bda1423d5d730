"""Streaming copies of the device-evidence probe: ``o = x * bf16(0.97)``.

The port of the two Pallas kernels of ``e2e/fused_bottleneck_probe.py``,
which measure how fast a hand-written kernel streams device memory beside
the framework's own elementwise code. Two wrappers over hand-written CUDA
kernels (``csrc/stream_copy.cu``), with one plain PyTorch version:

- :func:`stream_copy` — the counterpart of ``_pallas_copy(shape, block)``,
  the copy block-pipelined by the Pallas grid. ``block`` only validates, as
  ``block_q``/``block_k`` do for flash attention. The threads move the
  bytes: each block owns one contiguous 16 KB chunk of 16-byte vectors,
  one a thread, and the grid holds one block a chunk, as PyTorch launches
  its own elementwise kernels;
- :func:`stream_copy_dma` — the counterpart of ``_manual_dma_copy(m, c,
  bm)``, the hand double-buffered copy. The copy engine moves the bytes
  (TMA bulk copies) and the threads only scale: in each block a producer
  warp issues the loads of its tiles into a ring of shared-memory stages,
  and consumer warps scale each stage in place and store it from there.
  ``bm`` keeps its JAX meaning for validation; the device tile is the
  kernel's own.

The configuration each wrapper launches was chosen by the sweep
``kubeflow_tpu_torch.e2e.stream_copy_sweep``, which reaches every variant
(the designs these replaced among them) through the source's ``*_cfg``
entries.

``SCALE`` is ``bf16(0.97)`` = 0.96875 as a bf16 tensor: ``x * 0.97`` with a
Python float multiplies by 0.97 in f32 and gives other bits than the JAX
probe's ``x * jnp.bfloat16(0.97)``. The kernels compute
``bf16(float(x) * 0.96875f)`` rounded to nearest even, which is the plain
version bit for bit (the f32 product of two bf16 values is exact).

Both wrappers take contiguous bf16 only, 16-byte aligned with a size that
is a multiple of 8 elements, and refuse the shapes the Pallas kernels would
leave partly unwritten; they check on every device. A wrapper takes the
plain version only for a CPU tensor; for a CUDA tensor it launches the
kernel or raises. Each launch adds one to ``LAUNCHES[<name>]``.
"""

from __future__ import annotations

from typing import Dict, Sequence

import torch

from . import _build

SOURCE = "stream_copy.cu"

#: ``jnp.bfloat16(0.97)``: 0.96875
SCALE = torch.tensor(0.97, dtype=torch.bfloat16)

#: kernel launches per wrapper since the last :func:`reset_launches`
LAUNCHES: Dict[str, int] = {"stream_copy": 0, "stream_copy_dma": 0}


def reset_launches() -> None:
    for k in LAUNCHES:
        LAUNCHES[k] = 0


def stream_copy_plain(x: torch.Tensor) -> torch.Tensor:
    """``x * bf16(0.97)`` in bf16, on any device (a 0-dim CPU tensor
    multiplies a CUDA tensor as a scalar)."""
    return x * SCALE


def _check(name: str, x: torch.Tensor) -> None:
    if x.dtype != torch.bfloat16 or not x.is_contiguous():
        raise ValueError(f"{name}: takes a contiguous bf16 tensor, got {x.dtype} "
                         f"(contiguous: {x.is_contiguous()})")
    if x.data_ptr() % 16 or x.numel() % 8:
        raise ValueError(f"{name}: the kernel moves 16-byte vectors: needs a 16-byte "
                         f"aligned tensor of a multiple of 8 elements, got {x.numel()} "
                         f"at offset {x.data_ptr() % 16}")


def _launch(name: str, x: torch.Tensor) -> torch.Tensor:
    if x.device.type != "cuda":
        raise ValueError(f"{name}: x must lie on the CPU (plain version) or on a CUDA "
                         f"device, got {x.device}")
    out = torch.empty_like(x)
    stream = torch.cuda.current_stream(x.device).cuda_stream
    rc = _build.entry(SOURCE, name)(x.device.index, x.data_ptr(), out.data_ptr(),
                                    x.numel(), float(SCALE), stream)
    LAUNCHES[name] += 1
    if rc != 0:
        raise RuntimeError(f"{name}: CUDA launch failed with cudaError {rc}")
    return out


def stream_copy(x: torch.Tensor, block: Sequence[int]) -> torch.Tensor:
    """``x * bf16(0.97)`` through the ``stream_copy`` kernel; the plain
    version for a CPU x. ``block`` is the Pallas kernel's block shape:
    ``x.shape[0]`` must be a multiple of ``block[0]`` and ``block[1:]``
    must equal ``x.shape[1:]`` (its index map writes only block 0 of the
    other dims). Replaces the Pallas ``kern`` of
    ``e2e/fused_bottleneck_probe.py`` ``_pallas_copy``."""
    block = tuple(int(b) for b in block)
    shape = tuple(x.shape)
    if (len(block) != len(shape) or not shape or block[0] <= 0 or shape[0] % block[0]
            or block[1:] != shape[1:]):
        raise ValueError(f"stream_copy: block {block} does not tile shape {shape}: "
                         "dim 0 must be a multiple of block[0] and the other dims equal")
    _check("stream_copy", x)
    if x.device.type == "cpu":
        return stream_copy_plain(x)
    return _launch("stream_copy", x)


def stream_copy_dma(x: torch.Tensor, bm: int = 4096) -> torch.Tensor:
    """``x * bf16(0.97)`` of a 2-D ``[m, c]`` x through the
    ``stream_copy_dma`` kernel; the plain version for a CPU x. ``m`` must
    be a multiple of ``bm`` (the Pallas kernel never writes the tail rows)
    and hold at least two tiles (its last two waits address tiles nb-2 and
    nb-1). Replaces the Pallas ``kern`` of ``_manual_dma_copy``."""
    if x.dim() != 2:
        raise ValueError(f"stream_copy_dma: takes [m, c], got {tuple(x.shape)}")
    m = x.shape[0]
    if bm <= 0 or m % bm or m // bm < 2:
        raise ValueError(f"stream_copy_dma: m {m} must be a multiple of bm {bm} holding "
                         "at least two tiles")
    _check("stream_copy_dma", x)
    if x.device.type == "cpu":
        return stream_copy_plain(x)
    return _launch("stream_copy_dma", x)
