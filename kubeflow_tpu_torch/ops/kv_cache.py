"""KV-cache row writes for continuous-batching decode, and int8 KV
quantization.

The port of ``kubeflow_tpu/ops/kv_cache.py``. Each decode step writes ONE
``[H, D]`` key row and one value row per slot at that slot's cursor. The
wrappers, each over a hand-written CUDA kernel (``csrc/kv_cache.cu``) with a
plain PyTorch version beside it:

- :func:`kv_row_update` — contiguous per-slot cache ``[S, T, H, D]``;
- :func:`kv_block_update` — shared block arena ``[N, block_t, H, D]``
  through a per-slot block table ``[S, MB]``; arena row ``N-1`` is the
  trash block, so a write through an unallocated table entry lands there;
- :func:`kv_block_update_quant` — the same write into an int8 arena,
  quantized per (row, head) with the f32 scale written into
  ``[N, block_t, H, 1]`` beside it;
- :func:`kv_row_update_pair`, :func:`kv_block_update_pair` and
  :func:`kv_block_update_quant_pair` — a layer's K and V writes of the
  three above in ONE launch, the decode step's path. The one-array
  wrappers launch the same kernels over one array.

The writes are IN PLACE: the cache/arena passed in is modified and
returned (JAX got the same effect from ``input_output_aliases`` plus
donation). A cursor at or beyond ``T``/``max_seq`` writes nothing.

A wrapper takes its plain version only when the tensors lie on the CPU.
For CUDA tensors it launches the kernel or raises; it never falls back.
Each wrapper adds one to ``LAUNCHES[<name>]`` where it launches, so a run
can show the main path went through the kernel. :func:`kv_row_update_cfg`
and :func:`kv_block_update_cfg` (the pair kernel, or the one-array kernel
it replaced) and :func:`kv_launch_floor` (an empty kernel) are for timing
and count nothing.
"""

from __future__ import annotations

import threading
from typing import Dict, Optional, Sequence, Tuple

import torch

from . import _build

SOURCE = "kv_cache.cu"

#: kernel launches per wrapper since the last :func:`reset_launches`
LAUNCHES: Dict[str, int] = {"kv_row_update": 0, "kv_row_update_pair": 0,
                            "kv_block_update": 0, "kv_block_update_quant": 0,
                            "kv_block_update_pair": 0, "kv_block_update_quant_pair": 0}
#: the replicas of a fleet launch from one worker thread each
_LAUNCHES_LOCK = threading.Lock()

#: the raw pointer of a device's current stream: the value of
#: ``torch.cuda.current_stream(i).cuda_stream`` at a small part of its cost
_raw_stream = getattr(torch._C, "_cuda_getCurrentRawStream", None) or (
    lambda index: torch.cuda.current_stream(index).cuda_stream)


def reset_launches() -> None:
    for k in LAUNCHES:
        LAUNCHES[k] = 0


def _rows(new: torch.Tensor) -> torch.Tensor:
    """[S, 1, H, D] -> [S, H, D] (both layouts are accepted, as in JAX)."""
    return new[:, 0] if new.dim() == 4 else new


def _i32(t: torch.Tensor) -> torch.Tensor:
    """``t`` as contiguous int32, without a copy when it already is."""
    return t if t.dtype == torch.int32 and t.is_contiguous() else t.to(torch.int32).contiguous()


def _as(t: torch.Tensor, dtype: torch.dtype) -> torch.Tensor:
    """``t`` as contiguous ``dtype``, without a copy when it already is."""
    return t if t.dtype == dtype and t.is_contiguous() else t.to(dtype).contiguous()


def _check_cuda(name: str, target: torch.Tensor) -> None:
    """The timing entries have no plain version: CUDA tensors only."""
    if target.device.type != "cuda":
        raise ValueError(f"{name}: takes CUDA tensors only, got {target.device}")


def _check_write(name: str, written: Sequence[torch.Tensor], news: Sequence[torch.Tensor],
                 cursors: torch.Tensor, tables: Optional[torch.Tensor] = None) -> None:
    """The checks of a KV write, in one pass: ``written`` holds the caches
    or arenas (K first; each int8 arena followed by its scale arena),
    ``news`` the rows. Every tensor on the first written tensor's device,
    the written ones contiguous and disjoint, K's and V's caches and rows of
    one shape and type, rows ``[S, H, D]`` and cursors ``[S]`` for a
    contiguous cache ``[S, T, H, D]`` (``tables`` None) or for tables
    ``[S, MB]`` over an arena. Raises ValueError; a CPU tensor among CUDA
    ones too. Each tensor attribute is read once: on the decode path this
    runs 12 times a token."""
    dev = written[0].device
    kind = "caches" if tables is None else "arenas"
    if dev.type not in ("cpu", "cuda"):
        raise ValueError(f"{name}: tensors must lie on the CPU (plain "
                         f"version) or on a CUDA device, got {dev}")
    spans, shapes = [], []
    for t in written:
        if t.device != dev:
            raise ValueError(f"{name}: all tensors must be on {dev}, got one on {t.device}")
        if not t.is_contiguous():
            raise ValueError(f"{name}: the {kind} are written in place and must be "
                             "contiguous")
        lo = t.data_ptr()
        hi = lo + t.nbytes
        for a, b in spans:
            if lo < b and a < hi:
                raise ValueError(f"{name}: the {kind} written must not overlap")
        spans.append((lo, hi))
        shapes.append((t.shape, t.dtype))
    for t in (*news, cursors) if tables is None else (*news, cursors, tables):
        if t.device != dev:
            raise ValueError(f"{name}: all tensors must be on {dev}, got one on {t.device}")
    per = len(written) // len(news)
    if shapes[per:] != shapes[:len(shapes) - per]:
        raise ValueError(f"{name}: the K and V {kind} differ in shape or dtype")
    row = (news[0].shape, news[0].dtype)
    if len(news) == 2 and (news[1].shape, news[1].dtype) != row:
        raise ValueError(f"{name}: the K and V rows differ in shape or dtype")
    if tables is None:
        shape = shapes[0][0]
        if len(shape) != 4 or row[0] != (shape[0], *shape[2:]) or \
                cursors.shape != shape[:1]:
            raise ValueError(f"{name}: cache {tuple(shape)} needs new [S, H, D] and "
                             f"cursors [S] of its [S, T, H, D], got {tuple(row[0])} and "
                             f"{tuple(cursors.shape)}")
        return
    (N, bt, H, D), arena_dtype = shapes[0]
    tshape = tables.shape
    S = tshape[0]
    if len(tshape) != 2 or row[0] != (S, H, D) or cursors.shape != (S,):
        raise ValueError(f"{name}: arena {(N, bt, H, D)} and tables {tuple(tshape)} need "
                         f"new [{S}, {H}, {D}] and cursors [{S}], got {tuple(row[0])} "
                         f"and {tuple(cursors.shape)}")
    if per == 2 and (arena_dtype != torch.int8 or shapes[1] != ((N, bt, H, 1), torch.float32)):
        raise ValueError(f"{name}: needs an int8 arena and a contiguous f32 scale "
                         f"arena [{N}, {bt}, {H}, 1]")


def _launch(counter: Optional[str], name: str, target: torch.Tensor, *args) -> None:
    """Launch entry ``name`` on ``target``'s device and current stream;
    ``counter`` names the ``LAUNCHES`` entry it adds one to (None: none)."""
    device = target.get_device()
    rc = _build.entry(SOURCE, name)(device, *args, _raw_stream(device))
    if counter is not None:
        with _LAUNCHES_LOCK:
            LAUNCHES[counter] += 1
    if rc != 0:
        raise RuntimeError(f"{name}: CUDA launch failed with cudaError {rc}")


def kv_launch_floor(arena: torch.Tensor, n_slots: int) -> None:
    """An empty kernel at the one-array paged write's grid and block, through
    :func:`_launch` alone: the least a launch of a KV write takes on the
    device, and the least its call takes on the host. Counts nothing."""
    _launch(None, "kv_launch_floor", arena, int(n_slots),
            arena.shape[2] * arena.shape[3] * arena.element_size())


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
    ``kubeflow_tpu/ops/kv_cache.py``; launches the pair kernel over one
    array.
    """
    new = _rows(new)
    if cache.device.type == "cpu":
        return kv_row_update_plain(cache, new, cursors)
    _check_write("kv_row_update", (cache,), (new,), cursors)
    _launch_rows("kv_row_update", (cache,), (_as(new, cache.dtype),), cursors)
    return cache


def kv_row_update_pair_plain(k_cache: torch.Tensor, v_cache: torch.Tensor,
                             k_new: torch.Tensor, v_new: torch.Tensor,
                             cursors: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """Plain version of :func:`kv_row_update_pair`: the one-array plain
    version for K, then for V."""
    kv_row_update_plain(k_cache, k_new, cursors)
    kv_row_update_plain(v_cache, v_new, cursors)
    return k_cache, v_cache


def kv_row_update_pair(k_cache: torch.Tensor, v_cache: torch.Tensor,
                       k_new: torch.Tensor, v_new: torch.Tensor,
                       cursors: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """A layer's K and V rows into their two contiguous caches in one
    launch, in place: :func:`kv_row_update` on ``(k_cache, k_new)`` and on
    ``(v_cache, v_new)``, with the same contracts; returns ``(k_cache,
    v_cache)``. Refuses (ValueError) caches that overlap, the same tensor
    twice included, K and V caches or rows of different shapes or dtypes,
    and caches that are not contiguous."""
    k_new, v_new = _rows(k_new), _rows(v_new)
    _check_write("kv_row_update_pair", (k_cache, v_cache), (k_new, v_new), cursors)
    if k_cache.device.type == "cpu":
        return kv_row_update_pair_plain(k_cache, v_cache, k_new, v_new, cursors)
    dt = k_cache.dtype
    _launch_rows("kv_row_update_pair", (k_cache, v_cache), (_as(k_new, dt), _as(v_new, dt)),
                 cursors)
    return k_cache, v_cache


def _launch_rows(counter: Optional[str], caches, news, cursors,
                 design: Optional[int] = None) -> None:
    """Launch the contiguous write over one or two (cache, rows) pairs: the
    pair entry, or ``design`` through the timing entry."""
    k_cache = caches[0]
    S, T, H, D = k_cache.shape
    v_cache, v_new = (caches[1], news[1]) if len(caches) == 2 else (k_cache, news[0])
    cursors = _i32(cursors)  # alive until the launch is queued
    args = (k_cache.data_ptr(), v_cache.data_ptr(), news[0].data_ptr(), v_new.data_ptr(),
            len(caches), cursors.data_ptr(), S, T, H * D * k_cache.element_size())
    if design is None:
        _launch(counter, "kv_row_update_pair", k_cache, *args)
    else:
        _launch(counter, "kv_row_update_cfg", k_cache, int(design), *args)


def kv_row_update_cfg(design: int, k_cache: torch.Tensor, v_cache: Optional[torch.Tensor],
                      k_new: torch.Tensor, v_new: Optional[torch.Tensor],
                      cursors: torch.Tensor) -> None:
    """A design of the contiguous write on CUDA tensors, for timing: 0 is
    the replaced one-array kernel, launched once per array; 1 the pair
    kernel, a block per (slot, array), the row loaded before the cursor is
    tested (``csrc/kv_cache.cu``). ``v_cache`` None writes K only. Counts
    nothing in ``LAUNCHES``."""
    caches = (k_cache,) if v_cache is None else (k_cache, v_cache)
    news = (_rows(k_new),) if v_cache is None else (_rows(k_new), _rows(v_new))
    _check_cuda("kv_row_update_cfg", k_cache)
    _check_write("kv_row_update_cfg", caches, news, cursors)
    _launch_rows(None, caches, tuple(_as(n, k_cache.dtype) for n in news), cursors,
                 design=design)


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
    ``_paged_kernel`` of ``kubeflow_tpu/ops/kv_cache.py``; launches the
    pair kernel over one array.
    """
    new = _rows(new)
    if arena.device.type == "cpu":
        return kv_block_update_plain(arena, new, cursors, tables, max_seq=max_seq)
    _check_write("kv_block_update", (arena,), (new,), cursors, tables)
    _launch_pair("kv_block_update", (arena,), (_as(new, arena.dtype),), cursors, tables,
                 max_seq)
    return arena


def kv_block_update_pair_plain(k_arena: torch.Tensor, v_arena: torch.Tensor,
                               k_new: torch.Tensor, v_new: torch.Tensor,
                               cursors: torch.Tensor, tables: torch.Tensor, *,
                               max_seq: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """Plain version of :func:`kv_block_update_pair`: the one-array plain
    version for K, then for V."""
    kv_block_update_plain(k_arena, k_new, cursors, tables, max_seq=max_seq)
    kv_block_update_plain(v_arena, v_new, cursors, tables, max_seq=max_seq)
    return k_arena, v_arena


def kv_block_update_pair(k_arena: torch.Tensor, v_arena: torch.Tensor,
                         k_new: torch.Tensor, v_new: torch.Tensor,
                         cursors: torch.Tensor, tables: torch.Tensor, *,
                         max_seq: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """A layer's K and V rows into their two arenas in one launch, in place:
    :func:`kv_block_update` on ``(k_arena, k_new)`` and on ``(v_arena,
    v_new)``, with the same contracts; returns ``(k_arena, v_arena)``.
    Refuses (ValueError) arenas that overlap, the same tensor twice
    included, K and V arenas or rows of different shapes or dtypes, and
    arenas that are not contiguous."""
    k_new, v_new = _rows(k_new), _rows(v_new)
    _check_write("kv_block_update_pair", (k_arena, v_arena), (k_new, v_new), cursors,
                 tables)
    if k_arena.device.type == "cpu":
        return kv_block_update_pair_plain(k_arena, v_arena, k_new, v_new, cursors,
                                          tables, max_seq=max_seq)
    dt = k_arena.dtype
    _launch_pair("kv_block_update_pair", (k_arena, v_arena),
                 (_as(k_new, dt), _as(v_new, dt)), cursors, tables, max_seq)
    return k_arena, v_arena


def _launch_pair(counter: str, arenas, news, cursors, tables, max_seq: int) -> None:
    k_arena = arenas[0]
    N, bt, H, D = k_arena.shape
    S, mb = tables.shape
    v_arena, v_new = (arenas[1], news[1]) if len(arenas) == 2 else (k_arena, news[0])
    cursors, tables = _i32(cursors), _i32(tables)  # alive until the launch is queued
    _launch(counter, "kv_block_update_pair", k_arena, k_arena.data_ptr(),
            v_arena.data_ptr(), news[0].data_ptr(), v_new.data_ptr(), len(arenas),
            cursors.data_ptr(), tables.data_ptr(), S, mb, bt, int(max_seq), N,
            H * D * k_arena.element_size())


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


def _quant_rows(new: torch.Tensor) -> torch.Tensor:
    """The rows as the int8 kernels read them: bf16 or f32, contiguous."""
    if new.dtype not in (torch.bfloat16, torch.float32):
        new = new.float()
    return new.contiguous()


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
    ``_paged_quant_kernel`` of ``kubeflow_tpu/ops/kv_cache.py``; launches
    the pair kernel over one array.
    """
    new = _rows(new)
    if arena.device.type == "cpu":
        return kv_block_update_quant_plain(arena, scales, new, cursors, tables,
                                           max_seq=max_seq)
    _check_write("kv_block_update_quant", (arena, scales), (new,), cursors, tables)
    _launch_quant_pair("kv_block_update_quant", (arena, scales), (_quant_rows(new),),
                       cursors, tables, max_seq)
    return arena, scales


def kv_block_update_quant_pair_plain(k_arena: torch.Tensor, k_scales: torch.Tensor,
                                     v_arena: torch.Tensor, v_scales: torch.Tensor,
                                     k_new: torch.Tensor, v_new: torch.Tensor,
                                     cursors: torch.Tensor, tables: torch.Tensor, *,
                                     max_seq: int):
    """Plain version of :func:`kv_block_update_quant_pair`: the one-array
    plain version for K, then for V."""
    kv_block_update_quant_plain(k_arena, k_scales, k_new, cursors, tables,
                                max_seq=max_seq)
    kv_block_update_quant_plain(v_arena, v_scales, v_new, cursors, tables,
                                max_seq=max_seq)
    return k_arena, k_scales, v_arena, v_scales


def kv_block_update_quant_pair(k_arena: torch.Tensor, k_scales: torch.Tensor,
                               v_arena: torch.Tensor, v_scales: torch.Tensor,
                               k_new: torch.Tensor, v_new: torch.Tensor,
                               cursors: torch.Tensor, tables: torch.Tensor, *,
                               max_seq: int):
    """A layer's K and V rows, quantized, into their two int8 arenas and two
    scale arenas in one launch, in place: :func:`kv_block_update_quant` on
    each, with the same contracts; returns ``(k_arena, k_scales, v_arena,
    v_scales)``. Refuses (ValueError) arenas that overlap (any two of the
    four), K and V arenas or rows of different shapes or dtypes, and arenas
    that are not contiguous."""
    k_new, v_new = _rows(k_new), _rows(v_new)
    _check_write("kv_block_update_quant_pair", (k_arena, k_scales, v_arena, v_scales),
                 (k_new, v_new), cursors, tables)
    if k_arena.device.type == "cpu":
        return kv_block_update_quant_pair_plain(k_arena, k_scales, v_arena, v_scales,
                                                k_new, v_new, cursors, tables,
                                                max_seq=max_seq)
    _launch_quant_pair("kv_block_update_quant_pair", (k_arena, k_scales, v_arena, v_scales),
                       (_quant_rows(k_new), _quant_rows(v_new)), cursors, tables, max_seq)
    return k_arena, k_scales, v_arena, v_scales


def _launch_quant_pair(counter: str, written, news, cursors, tables, max_seq: int) -> None:
    k_arena, k_scales = written[0], written[1]
    v_arena, v_scales = (written[2], written[3]) if len(written) == 4 else written[:2]
    N, bt, H, D = k_arena.shape
    S, mb = tables.shape
    cursors, tables = _i32(cursors), _i32(tables)  # alive until the launch is queued
    _launch(counter, "kv_block_update_quant_pair", k_arena, k_arena.data_ptr(),
            v_arena.data_ptr(), k_scales.data_ptr(), v_scales.data_ptr(),
            news[0].data_ptr(), news[-1].data_ptr(), int(news[0].dtype == torch.bfloat16),
            len(news), cursors.data_ptr(), tables.data_ptr(), S, mb, bt, int(max_seq),
            N, H, D)


def kv_block_update_cfg(design: int, k_arena: torch.Tensor, v_arena: Optional[torch.Tensor],
                        k_new: torch.Tensor, v_new: Optional[torch.Tensor],
                        cursors: torch.Tensor, tables: torch.Tensor, *, max_seq: int,
                        k_scales: Optional[torch.Tensor] = None,
                        v_scales: Optional[torch.Tensor] = None) -> None:
    """A design of the paged writes on CUDA tensors, for timing: 0 is the
    replaced one-array kernel, launched once per array; 1 the pair kernel, a
    block per (slot, array) (``csrc/kv_cache.cu``).
    ``v_arena`` None writes K only; scale arenas select the int8 write.
    Counts nothing in ``LAUNCHES``."""
    quant = k_scales is not None
    written = [k_arena] + ([k_scales] if quant else [])
    news = [_rows(k_new)]
    if v_arena is not None:
        written += [v_arena] + ([v_scales] if quant else [])
        news.append(_rows(v_new))
    _check_cuda("kv_block_update_cfg", k_arena)
    _check_write("kv_block_update_cfg", written, news, cursors, tables)
    news = [_quant_rows(n) if quant else _as(n, k_arena.dtype) for n in news]
    N, bt, H, D = k_arena.shape
    S, mb = tables.shape
    last = len(written) - (2 if quant else 1)
    cursors, tables = _i32(cursors), _i32(tables)
    _launch(None, "kv_block_update_cfg", k_arena, int(design), int(quant),
            k_arena.data_ptr(), written[last].data_ptr(),
            k_scales.data_ptr() if quant else None,
            written[-1].data_ptr() if quant else None,
            news[0].data_ptr(), news[-1].data_ptr(), int(news[0].dtype == torch.bfloat16),
            len(news), cursors.data_ptr(), tables.data_ptr(), S, mb, bt, int(max_seq),
            N, H, D, H * D * k_arena.element_size())


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
