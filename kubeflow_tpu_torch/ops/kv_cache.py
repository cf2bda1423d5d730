"""KV-cache row writes for continuous-batching decode, and int8 KV
quantization.

The port of ``kubeflow_tpu/ops/kv_cache.py``. Each decode step writes ONE
``[H, D]`` key row and one value row per slot at that slot's cursor. Three
wrappers, each over a hand-written CUDA kernel (``csrc/kv_cache.cu``) with a
plain PyTorch version beside it:

- :func:`kv_row_update` — contiguous per-slot cache ``[S, T, H, D]``;
- :func:`kv_block_update` — shared block arena ``[N, block_t, H, D]``
  through a per-slot block table ``[S, MB]``; arena row ``N-1`` is the
  trash block, so a write through an unallocated table entry lands there;
- :func:`kv_block_update_quant` — the same write into an int8 arena,
  quantized per (row, head) with the f32 scale written into
  ``[N, block_t, H, 1]`` beside it.

The writes are IN PLACE: the cache/arena passed in is modified and
returned (JAX got the same effect from ``input_output_aliases`` plus
donation). A cursor at or beyond ``T``/``max_seq`` writes nothing.

A wrapper takes its plain version only when the tensors lie on the CPU.
For CUDA tensors it launches the kernel or raises; it never falls back.
Each wrapper adds one to ``LAUNCHES[<name>]`` where it launches, so a run
can show the main path went through the kernel.
"""

from __future__ import annotations

from typing import Dict, Tuple

import torch

from . import _build

SOURCE = "kv_cache.cu"

#: kernel launches per wrapper since the last :func:`reset_launches`
LAUNCHES: Dict[str, int] = {"kv_row_update": 0, "kv_block_update": 0,
                            "kv_block_update_quant": 0}


def reset_launches() -> None:
    for k in LAUNCHES:
        LAUNCHES[k] = 0


def _rows(new: torch.Tensor) -> torch.Tensor:
    """[S, 1, H, D] -> [S, H, D] (both layouts are accepted, as in JAX)."""
    return new[:, 0] if new.dim() == 4 else new


def _check_cuda(name: str, target: torch.Tensor, *others: torch.Tensor) -> None:
    if target.device.type != "cuda":
        raise ValueError(f"{name}: tensors must lie on the CPU (plain "
                         f"version) or on a CUDA device, got {target.device}")
    for t in others:
        if t.device != target.device:
            raise ValueError(f"{name}: all tensors must be on {target.device}, "
                             f"got one on {t.device}")
    if not target.is_contiguous():
        raise ValueError(f"{name}: the cache is written in place and must be "
                         "contiguous")


def _launch(name: str, target: torch.Tensor, *args) -> None:
    """Launch ``name`` on ``target``'s device and current stream; the
    library's own CUDA runtime is told the device with every call."""
    stream = torch.cuda.current_stream(target.device).cuda_stream
    rc = _build.entry(SOURCE, name)(target.device.index, *args, stream)
    LAUNCHES[name] += 1
    if rc != 0:
        raise RuntimeError(f"{name}: CUDA launch failed with cudaError {rc}")


# -- int8 quantization -------------------------------------------------------

def quantize_kv(x: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """Quantize KV vectors symmetrically per head row.

    x: [..., H, D] (bf16/f32) -> (int8 [..., H, D], f32 scales [..., H, 1]).
    The scale is ``absmax / 127`` by true IEEE division (the divisor is a
    tensor: PyTorch turns division by a Python scalar on CUDA into a
    reciprocal multiply, which moves the scale by an ULP); codes round half
    to even and clamp to ±127. An all-zero row gets scale 0 and codes 0.
    """
    xf = x.float()
    amax = xf.abs().amax(dim=-1, keepdim=True)
    scale = amax / torch.full_like(amax, 127.0)
    div = torch.where(scale > 0, scale, torch.ones_like(scale))
    q = torch.round(xf / div).clamp(-127, 127).to(torch.int8)
    return q, scale


def dequantize_kv(q: torch.Tensor, scale: torch.Tensor) -> torch.Tensor:
    """Inverse of :func:`quantize_kv` (f32 out)."""
    return q.float() * scale


# -- contiguous per-slot cache ----------------------------------------------

def kv_row_update_plain(cache: torch.Tensor, new: torch.Tensor,
                        cursors: torch.Tensor) -> torch.Tensor:
    """Plain version of :func:`kv_row_update` (in place). Rows outside
    ``[0, T)`` write back what they read, so the update stays one gather
    and one scatter with no host synchronisation."""
    new = _rows(new)
    S, T = cache.shape[:2]
    rows = torch.arange(S, device=cache.device)
    cur = cursors.to(device=cache.device, dtype=torch.long)
    valid = (cur >= 0) & (cur < T)
    idx = cur.clamp(0, T - 1)
    old = cache[rows, idx]
    cache[rows, idx] = torch.where(valid[:, None, None], new.to(cache.dtype), old)
    return cache


def kv_row_update(cache: torch.Tensor, new: torch.Tensor,
                  cursors: torch.Tensor) -> torch.Tensor:
    """Write ``new[s]`` at ``cache[s, cursors[s]]`` in place; returns cache.

    cache: [S, T, H, D]; new: [S, H, D] (or [S, 1, H, D]); cursors: [S].
    Cursors outside ``[0, T)`` are a no-op for that row (retired and idle
    rows keep stepping past their end). Replaces the Pallas ``_kernel`` of
    ``kubeflow_tpu/ops/kv_cache.py``.
    """
    new = _rows(new)
    if cache.device.type == "cpu":
        return kv_row_update_plain(cache, new, cursors)
    _check_cuda("kv_row_update", cache, new, cursors)
    S, T, H, D = cache.shape
    if new.shape != (S, H, D) or cursors.shape != (S,):
        raise ValueError(f"kv_row_update: cache {tuple(cache.shape)} needs new "
                         f"[{S}, {H}, {D}] and cursors [{S}], got "
                         f"{tuple(new.shape)} and {tuple(cursors.shape)}")
    new = new.to(cache.dtype).contiguous()
    cursors = cursors.to(torch.int32).contiguous()
    _launch("kv_row_update", cache, cache.data_ptr(), new.data_ptr(),
            cursors.data_ptr(), S, T, H * D * cache.element_size())
    return cache


# -- paged block arena --------------------------------------------------------

def _paged_targets(arena: torch.Tensor, cursors: torch.Tensor,
                   tables: torch.Tensor, max_seq: int):
    """(valid [S], block [S], offset [S]) of each slot's write."""
    N, bt = arena.shape[:2]
    mb = tables.shape[1]
    rows = torch.arange(tables.shape[0], device=arena.device)
    cur = cursors.to(device=arena.device, dtype=torch.long)
    pos = cur.clamp(0, max_seq - 1)
    blk = tables.to(arena.device).long()[rows, (pos // bt).clamp(max=mb - 1)]
    valid = (cur >= 0) & (cur < max_seq) & (blk >= 0) & (blk < N)
    return valid, blk, pos % bt


def kv_block_update_plain(arena: torch.Tensor, new: torch.Tensor,
                          cursors: torch.Tensor, tables: torch.Tensor, *,
                          max_seq: int) -> torch.Tensor:
    """Plain version of :func:`kv_block_update` (in place). Selects the
    valid rows with a boolean mask: a host synchronisation on the card,
    where this version only serves as the kernel's reference."""
    valid, blk, off = _paged_targets(arena, cursors, tables, max_seq)
    arena[blk[valid], off[valid]] = _rows(new).to(arena.dtype)[valid]
    return arena


def kv_block_update(arena: torch.Tensor, new: torch.Tensor,
                    cursors: torch.Tensor, tables: torch.Tensor, *,
                    max_seq: int) -> torch.Tensor:
    """Paged generalization of :func:`kv_row_update`, in place.

    arena: [N, block_t, H, D] shared block arena (row N-1 is the trash
    block); new: [S, H, D] (or [S, 1, H, D]); cursors: [S] absolute
    positions; tables: [S, MB] arena row ids per slot. Writes ``new[s]`` at
    ``arena[tables[s, cursors[s] // block_t], cursors[s] % block_t]``.
    Cursors at or beyond ``max_seq`` write nothing; positions whose table
    entry is the trash block land in the trash row. Replaces the Pallas
    ``_paged_kernel`` of ``kubeflow_tpu/ops/kv_cache.py``.
    """
    new = _rows(new)
    if arena.device.type == "cpu":
        return kv_block_update_plain(arena, new, cursors, tables, max_seq=max_seq)
    _check_cuda("kv_block_update", arena, new, cursors, tables)
    N, bt, H, D = arena.shape
    S, mb = tables.shape
    if new.shape != (S, H, D) or cursors.shape != (S,):
        raise ValueError(f"kv_block_update: arena {tuple(arena.shape)} and "
                         f"tables {tuple(tables.shape)} need new [{S}, {H}, {D}] "
                         f"and cursors [{S}], got {tuple(new.shape)} and "
                         f"{tuple(cursors.shape)}")
    new = new.to(arena.dtype).contiguous()
    cursors = cursors.to(torch.int32).contiguous()
    tables = tables.to(torch.int32).contiguous()
    _launch("kv_block_update", arena, arena.data_ptr(), new.data_ptr(),
            cursors.data_ptr(), tables.data_ptr(), S, mb, bt, int(max_seq), N,
            H * D * arena.element_size())
    return arena


def kv_block_update_quant_plain(arena: torch.Tensor, scales: torch.Tensor,
                                new: torch.Tensor, cursors: torch.Tensor,
                                tables: torch.Tensor, *, max_seq: int
                                ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Plain version of :func:`kv_block_update_quant` (in place):
    :func:`quantize_kv` then the masked row write of value and scale."""
    valid, blk, off = _paged_targets(arena, cursors, tables, max_seq)
    q, s = quantize_kv(_rows(new))
    arena[blk[valid], off[valid]] = q[valid]
    scales[blk[valid], off[valid]] = s[valid]
    return arena, scales


def kv_block_update_quant(arena: torch.Tensor, scales: torch.Tensor,
                          new: torch.Tensor, cursors: torch.Tensor,
                          tables: torch.Tensor, *, max_seq: int
                          ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Store-quantized variant of :func:`kv_block_update`, in place.

    arena: [N, block_t, H, D] int8; scales: [N, block_t, H, 1] f32; new:
    [S, H, D] (or [S, 1, H, D]) bf16/f32. Quantizes ``new`` inside the
    kernel (the math of :func:`quantize_kv`, bit for bit) and writes value
    and scale through the block table; returns ``(arena, scales)``. Same
    out-of-range no-op contract as the bf16 kernel. Replaces the Pallas
    ``_paged_quant_kernel`` of ``kubeflow_tpu/ops/kv_cache.py``.
    """
    new = _rows(new)
    if arena.device.type == "cpu":
        return kv_block_update_quant_plain(arena, scales, new, cursors, tables,
                                           max_seq=max_seq)
    _check_cuda("kv_block_update_quant", arena, scales, new, cursors, tables)
    N, bt, H, D = arena.shape
    S, mb = tables.shape
    if (arena.dtype != torch.int8 or scales.dtype != torch.float32
            or scales.shape != (N, bt, H, 1) or not scales.is_contiguous()):
        raise ValueError("kv_block_update_quant: needs an int8 arena and a "
                         f"contiguous f32 scale arena [{N}, {bt}, {H}, 1]")
    if new.shape != (S, H, D) or cursors.shape != (S,):
        raise ValueError(f"kv_block_update_quant: needs new [{S}, {H}, {D}] "
                         f"and cursors [{S}], got {tuple(new.shape)} and "
                         f"{tuple(cursors.shape)}")
    if new.dtype not in (torch.bfloat16, torch.float32):
        new = new.float()
    new = new.contiguous()
    cursors = cursors.to(torch.int32).contiguous()
    tables = tables.to(torch.int32).contiguous()
    _launch("kv_block_update_quant", arena, arena.data_ptr(), scales.data_ptr(),
            new.data_ptr(), int(new.dtype == torch.bfloat16), cursors.data_ptr(),
            tables.data_ptr(), S, mb, bt, int(max_seq), N, H, D)
    return arena, scales


def kv_block_update_ref(arena: torch.Tensor, seg: torch.Tensor,
                        cursors: torch.Tensor, tables: torch.Tensor, *,
                        max_seq: int) -> torch.Tensor:
    """Scatter reference for :func:`kv_block_update`, generalized to
    multi-token segments, in place.

    arena: [N, block_t, H, D]; seg: [S, L, H, D]; cursors: [S] (position of
    ``seg[:, 0]``); tables: [S, MB]. Out-of-range positions are redirected
    to the trash row (N-1) instead of being skipped, so each token stays
    one scatter with no host synchronisation.
    """
    N, bt = arena.shape[:2]
    S, L = seg.shape[:2]
    mb = tables.shape[1]
    rows = torch.arange(S, device=arena.device)
    cur = cursors.to(device=arena.device, dtype=torch.long)
    tables = tables.to(arena.device).long()
    trash = torch.full_like(cur, N - 1)
    for j in range(L):
        pos = cur + j
        bi = (pos // bt).clamp(0, mb - 1)
        blk = torch.where(pos < max_seq, tables[rows, bi], trash)
        arena[blk, pos % bt] = seg[:, j].to(arena.dtype)
    return arena
