"""Variant sweep of the streaming-copy kernels on the card.

Every launch configuration of ``stream_copy`` and ``stream_copy_dma``
(``ops/csrc/stream_copy.cu``, through its entries ``stream_copy_cfg`` and
``stream_copy_dma_cfg``), the designs they replaced among them (design 0
of each), is held bit for bit against ``stream_copy_plain`` on the probe's
array (bf16 ``[802816, 256]``, 822 MB moved) and timed beside
``torch.mul(x, SCALE)``, the library's own streaming. Device ms: CUDA
events recorded on the stream around each launch, the mean over ``iters``
launches; the sweep takes ``reps`` such means of every variant in turns
and reports their median, so that the card's drift falls on all variants
alike. The bound is the bytes (x read once, the output written once) at
the catalog's memory rate.

One JSON line a (kernel, variant) with its device ms, bound share, the
factor against ``torch.mul`` of the same run and whether the wrappers use
it (``picked``); then the launch shapes (grid, block, registers) of
``torch.mul`` and of the two wrappers' kernels, read from a profiler
trace; then the card's name and power limit. On the card::

    python -m kubeflow_tpu_torch.e2e.stream_copy_sweep [--kernel stream_copy_dma]
"""

from __future__ import annotations

import argparse
import json
import os
import statistics
import subprocess
import tempfile
from typing import Callable, Dict, List, Optional

import torch

from ..device import resolve_device
from ..ops import _build
from ..ops import stream_copy as sc

#: the probe's flat array: 256 * 56 * 56 rows of 256 channels
ROWS, COLS = 256 * 56 * 56, 256

LOADS = {"cs": 0, "nc_l2_256b": 1, "plain": 2}
STORES = {"plain": 0, "cs": 1}
#: a block may use 227 KB of shared memory, an SM holds 228 KB and reserves
#: 1 KB a block; the ring's mbarriers take 128 bytes
SMEM_PER_BLOCK, SMEM_PER_SM, SMEM_RESERVED, RING_BARRIERS = 232448, 233472, 1024, 128

Variant = Dict[str, object]

#: the variants the wrappers launch: the constants COPY_* and DMA_* of
#: stream_copy.cu (a CPU test holds the two alike)
CHOSEN: Dict[str, Variant] = {
    "stream_copy": dict(design="chunks", threads=1024, unroll=1, load="plain", store="plain",
                        blocks_per_sm=0),
    "stream_copy_dma": dict(design="ring", stages=2, tile=8192, blocks_per_sm=0,
                            tiles_per_block=2, consumer_warps=8, store_lag=1, evict_first=0),
}
#: the earlier designs, which the chosen ones replaced
PARENT: Dict[str, Variant] = {"stream_copy": dict(design="grid_stride"),
                              "stream_copy_dma": dict(design="two_slot")}


def ring_fits(stages: int, tile: int, blocks_per_sm: int) -> bool:
    """Whether ``blocks_per_sm`` ring blocks of ``stages`` x ``tile`` bytes
    fit in an SM's shared memory."""
    block = stages * tile + RING_BARRIERS
    return (block <= SMEM_PER_BLOCK
            and blocks_per_sm * (block + SMEM_RESERVED) <= SMEM_PER_SM)


def variants(kernel: str) -> List[Variant]:
    """Every configuration the sweep launches, the parent design first."""
    out: List[Variant] = [dict(PARENT[kernel])]
    if kernel == "stream_copy":
        out += [dict(design="chunks", threads=t, unroll=u, load=ld, store=st, blocks_per_sm=b)
                for t in (128, 256, 512, 1024) for u in (1, 2, 4, 8) for ld in LOADS
                for st in STORES for b in (0, 4, 8, 16)]
    else:
        # persistent grids of 1 or 2 blocks an SM
        out += [dict(design="ring", stages=s, tile=t, blocks_per_sm=b, tiles_per_block=0,
                     consumer_warps=w, store_lag=lag, evict_first=e)
                for b in (1, 2) for t in (16384, 24576, 32768, 49152) for s in range(3, 9)
                for w in (2, 4, 8) for lag in range(4) for e in (0, 1)
                if ring_fits(s, t, b) and lag < s]
        # a block for every `n` consecutive tiles
        out += [dict(design="ring", stages=s, tile=t, blocks_per_sm=0, tiles_per_block=n,
                     consumer_warps=w, store_lag=lag, evict_first=0)
                for n in (1, 2, 3, 4, 6, 8, 16, 32) for t in (8192, 16384, 24576, 32768, 49152)
                for s in (2, 3, 4, 6) for w in (4, 8) for lag in (1, 2, 3)
                if lag < s and ring_fits(s, t, 1)]
    return out


def label(v: Variant) -> str:
    return ",".join(f"{k}={val}" for k, val in v.items())


def launch(kernel: str, v: Variant, x: torch.Tensor, out: torch.Tensor) -> torch.Tensor:
    """``out = x * SCALE`` through variant ``v`` of ``kernel``; raises if
    the launch fails. Not counted in ``stream_copy.LAUNCHES``."""
    if x.dtype != torch.bfloat16 or not x.is_cuda or not x.is_contiguous():
        raise ValueError(f"{kernel}: takes a contiguous bf16 CUDA tensor")
    if x.data_ptr() % 16 or out.data_ptr() % 16 or x.numel() % 8 or out.shape != x.shape:
        raise ValueError(f"{kernel}: 16-byte aligned tensors of one shape, a multiple of 8 "
                         "elements")
    stream = torch.cuda.current_stream(x.device).cuda_stream
    head = (x.device.index, x.data_ptr(), out.data_ptr(), x.numel(), float(sc.SCALE))
    if kernel == "stream_copy":
        cfg = (0,) * 6 if v["design"] == "grid_stride" else (
            1, v["threads"], v["unroll"], LOADS[v["load"]], STORES[v["store"]],
            v["blocks_per_sm"])
    else:
        cfg = (0,) * 8 if v["design"] == "two_slot" else (
            1, v["stages"], v["tile"], v["blocks_per_sm"], v["tiles_per_block"],
            v["consumer_warps"], v["store_lag"], v["evict_first"])
    rc = _build.entry(sc.SOURCE, kernel + "_cfg")(*head, *cfg, stream)
    if rc != 0:
        raise RuntimeError(f"{kernel} {label(v)}: CUDA launch failed with cudaError {rc}")
    return out


def event_ms(fn: Callable[[], object], iters: int = 20, warmup: int = 3) -> float:
    """Mean device ms of one ``fn()`` over ``iters`` calls, each between two
    CUDA events on the current stream (the gaps between calls left out)."""
    for _ in range(warmup):
        fn()
    pairs = [(torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True))
             for _ in range(iters)]
    for start, end in pairs:
        start.record()
        fn()
        end.record()
    torch.cuda.synchronize()
    return sum(start.elapsed_time(end) for start, end in pairs) / iters


def launch_shapes(fn: Callable[[], object], iters: int = 10, takes: int = 8) -> List[dict]:
    """Name, grid, block, registers per thread and shared memory of each
    kernel that ``fn()`` launches, read from a torch.profiler chrome trace
    of ``iters`` calls (after a warm-up cycle), one entry a distinct launch.
    A window that kept no kernel record (the profiler drops some, the more
    the longer a process has run) is taken again, up to ``takes`` times."""
    from torch.profiler import ProfilerActivity, profile, schedule

    for _ in range(takes):
        with profile(activities=[ProfilerActivity.CUDA],
                     schedule=schedule(wait=0, warmup=1, active=1, repeat=1)) as prof:
            for _ in range(2):
                for _ in range(iters):
                    fn()
                torch.cuda.synchronize()
                prof.step()
        with tempfile.TemporaryDirectory() as tmp:
            path = os.path.join(tmp, "trace.json")
            prof.export_chrome_trace(path)
            with open(path) as f:
                events = json.load(f)["traceEvents"]
        shapes = []
        for e in events:
            if e.get("cat") != "kernel":
                continue
            shape = dict(name=e["name"][:120], grid=e["args"].get("grid"),
                         block=e["args"].get("block"),
                         registers_per_thread=e["args"].get("registers per thread"),
                         shared_memory=e["args"].get("shared memory"))
            if shape not in shapes:
                shapes.append(shape)
        if shapes:
            return shapes
    raise AssertionError(f"the profiler kept no kernel record in {takes} windows")


def sweep(kernels: List[str], iters: int = 20, reps: int = 3, device: str = "cuda") -> List[dict]:
    """One row a (kernel, variant): the median over ``reps`` of its device
    ms, beside ``torch.mul``'s of the same turns."""
    from ..training import flops

    dev = resolve_device(device)
    g = torch.Generator(device=dev).manual_seed(0)
    x = (torch.randn(ROWS, COLS, generator=g, device=dev) * 0.3).to(torch.bfloat16)
    want = sc.stream_copy_plain(x)
    out = torch.empty_like(x)
    nbytes = 2.0 * x.numel() * x.element_size()
    bound_ms = nbytes / flops.peak_hbm_bandwidth(flops.detect_generation(dev)) * 1e3
    todo = [(k, v) for k in kernels for v in variants(k)]
    for k, v in todo:
        for _ in range(2):
            out.zero_()
            if not torch.equal(launch(k, v, x, out), want):
                raise AssertionError(f"{k} {label(v)}: differs from stream_copy_plain")
    times: Dict[int, List[float]] = {i: [] for i in range(len(todo))}
    lib: List[float] = []
    for _ in range(reps):
        lib.append(event_ms(lambda: torch.mul(x, sc.SCALE), iters))
        for i, (k, v) in enumerate(todo):
            times[i].append(event_ms(lambda: launch(k, v, x, out), iters))
    lib_ms = statistics.median(lib)
    rows = []
    for i, (k, v) in enumerate(todo):
        ms = statistics.median(times[i])
        rows.append(dict(kernel=k, variant=v, picked=v == CHOSEN[k], parent=v == PARENT[k],
                         bit_equal=True, device_ms=ms, device_ms_reps=times[i],
                         bound_ms=bound_ms, bound_share=bound_ms / ms,
                         torch_mul_device_ms=lib_ms, over_torch_mul=ms / lib_ms))
        print(json.dumps(rows[-1]), flush=True)
    return rows


def main(argv: Optional[List[str]] = None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--kernel", choices=sorted(CHOSEN), action="append")
    ap.add_argument("--iters", type=int, default=20)
    ap.add_argument("--reps", type=int, default=3)
    a = ap.parse_args(argv)
    sweep(a.kernel or sorted(CHOSEN), a.iters, a.reps)
    x = torch.zeros(ROWS, COLS, dtype=torch.bfloat16, device=resolve_device("cuda"))
    print(json.dumps({"launch_shapes": {
        "torch_mul": launch_shapes(lambda: torch.mul(x, sc.SCALE)),
        "stream_copy": launch_shapes(lambda: sc.stream_copy(x, (ROWS, COLS))),
        "stream_copy_dma": launch_shapes(lambda: sc.stream_copy_dma(x))}}))
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True, text=True).stdout
    print(json.dumps({"device": torch.cuda.get_device_name(), "card": card.strip()}))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
