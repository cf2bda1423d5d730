"""Build the port's CUDA kernels at first use and load them with ctypes.

Each ``csrc/*.cu`` source has a plain C interface (pointers, ints, a
stream; every entry point returns ``cudaGetLastError()``), so it compiles
with ``nvcc`` alone in seconds — no PyTorch headers, no ninja. The shared
library lands in ``ops/_build/`` (git-ignored), named by a hash of the
source and the flags: an edited source rebuilds, an unchanged one loads.

A failed build raises. Nothing falls back to the plain PyTorch versions:
those run only for tensors that lie on the CPU.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path
from typing import Callable, Dict, Tuple

CSRC = Path(__file__).resolve().parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parent / "_build"

NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC")

_libs: Dict[str, ctypes.CDLL] = {}

P, I, L, F = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong, ctypes.c_float

#: C signatures of every entry point, by source. Each takes the CUDA device
#: ordinal first and returns an int (the cudaError_t of the launch).
SIGNATURES: Dict[str, Dict[str, Tuple]] = {
    "kv_cache.cu": {
        # device, k_cache, v_cache, k_new, v_new, n_arrays, cursors, S, T,
        # row_bytes, stream
        "kv_row_update_pair": (I, P, P, P, P, I, P, I, I, I, P),
        # device, design, then as kv_row_update_pair
        "kv_row_update_cfg": (I, I, P, P, P, P, I, P, I, I, I, P),
        # device, k_arena, v_arena, k_new, v_new, n_arrays, cursors, tables,
        # S, mb, block_t, max_seq, n_blocks, row_bytes, stream
        "kv_block_update_pair": (I, P, P, P, P, I, P, P, I, I, I, I, I, I, P),
        # device, k_arena, v_arena, k_scales, v_scales, k_new, v_new,
        # new_is_bf16, n_arrays, cursors, tables, S, mb, block_t, max_seq,
        # n_blocks, H, D, stream
        "kv_block_update_quant_pair": (I, *(P,) * 6, I, I, P, P, *(I,) * 7, P),
        # device, design, quant, k_arena, v_arena, k_scales, v_scales, k_new,
        # v_new, new_is_bf16, n_arrays, cursors, tables, S, mb, block_t,
        # max_seq, n_blocks, H, D, row_bytes, stream
        "kv_block_update_cfg": (I, I, I, *(P,) * 6, I, I, P, P, *(I,) * 8, P),
        # device, S, row_bytes, stream
        "kv_launch_floor": (I, I, I, P),
    },
    "flash_attention.cu": {
        # device, q, k, v, out, lse, is_bf16, b, lq, lk, h, d, scale, causal,
        # q_offset, k_offset, bf16_dots, stream
        "flash_fwd": (I, P, P, P, P, P, I, I, I, I, I, I, F, I, I, I, I, P),
        # device, q, k, v, dout, lse, delta, dq, is_bf16, b, lq, lk, h, d,
        # scale, causal, q_offset, k_offset, bf16_dots, stream
        "flash_bwd_dq": (I, P, P, P, P, P, P, P, I, I, I, I, I, I, F, I, I, I, I, P),
        # as flash_bwd_dq with dk, dv in place of dq
        "flash_bwd_dkv": (I, P, P, P, P, P, P, P, P, I, I, I, I, I, I, F, I, I, I, I, P),
    },
    "fused_bottleneck.cu": {
        # device, x, w1t, s1, b1, w2t, s2, b2, w3t, s3, b3, out, is_bf16, n,
        # hw, cin, cmid, band, stream
        "fused_bottleneck": (I, *(P,) * 11, I, I, I, I, I, I, P),
        # device, x, w1t, s1, b1, w2t, s2, b2, w3t, s3, b3, wpt, sp, bp, out,
        # is_bf16, n, hw, cin, cmid, cout, stride, band, stream
        "fused_transition": (I, *(P,) * 14, *(I,) * 8, P),
    },
    "stream_copy.cu": {
        # device, x, out, n_elems, scale, stream
        "stream_copy": (I, P, P, L, F, P),
        "stream_copy_dma": (I, P, P, L, F, P),
        # device, x, out, n_elems, scale, design, threads, unroll, load,
        # store, blocks_per_sm, stream
        "stream_copy_cfg": (I, P, P, L, F, I, I, I, I, I, I, P),
        # device, x, out, n_elems, scale, design, stages, tile,
        # blocks_per_sm, tiles_per_block, consumer_warps, store_lag,
        # evict_first, stream
        "stream_copy_dma_cfg": (I, P, P, L, F, *(I,) * 8, P),
    },
}

#: one lock per source: a source is built and loaded once, while different
#: sources may build at the same time (see :func:`load_all`)
_locks: Dict[str, threading.Lock] = {source: threading.Lock() for source in SIGNATURES}


def nvcc() -> str:
    """Path of ``nvcc``: ``$CUDA_HOME/bin``, then ``PATH``, then
    ``/usr/local/cuda/bin``."""
    candidates = []
    if os.environ.get("CUDA_HOME"):
        candidates.append(os.path.join(os.environ["CUDA_HOME"], "bin", "nvcc"))
    found = shutil.which("nvcc")
    if found:
        candidates.append(found)
    candidates.append("/usr/local/cuda/bin/nvcc")
    for c in candidates:
        if os.path.isfile(c) and os.access(c, os.X_OK):
            return c
    raise RuntimeError("nvcc not found (set CUDA_HOME); the port's CUDA "
                       "kernels build from source at first use")


def library_path(source: str) -> Path:
    src = (CSRC / source).read_bytes()
    digest = hashlib.sha256(src + " ".join(NVCC_FLAGS).encode()).hexdigest()[:16]
    return BUILD_DIR / f"lib{Path(source).stem}_{digest}.so"


def build(source: str) -> Path:
    """Compile ``csrc/<source>`` unless a library for its current hash
    exists; returns the library's path."""
    out = library_path(source)
    if out.exists():
        return out
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = out.with_suffix(f".{os.getpid()}.tmp")
    cmd = [nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(CSRC / source)]
    proc = subprocess.run(cmd, capture_output=True, text=True)
    if proc.returncode != 0:
        tmp.unlink(missing_ok=True)
        raise RuntimeError(f"nvcc failed for {source} (rc {proc.returncode}):\n"
                           f"{' '.join(cmd)}\n{proc.stdout}{proc.stderr}")
    os.replace(tmp, out)  # atomic: a concurrent loader never sees half a file
    return out


def load(source: str) -> ctypes.CDLL:
    """The loaded library of ``csrc/<source>``, building it first if needed,
    with every entry point's argtypes/restype declared."""
    with _locks[source]:
        lib = _libs.get(source)
        if lib is not None:
            return lib
        lib = ctypes.CDLL(str(build(source)))
        for name, argtypes in SIGNATURES[source].items():
            fn = getattr(lib, name)
            fn.argtypes = list(argtypes)
            fn.restype = ctypes.c_int
        _libs[source] = lib
        return lib


def load_all() -> None:
    """Build and load every source, one ``nvcc`` per source, all started
    together."""
    with ThreadPoolExecutor(max_workers=len(SIGNATURES)) as pool:
        for future in [pool.submit(load, source) for source in SIGNATURES]:
            future.result()


#: bound entry points by (source, name), filled at first use: a call of
#: :func:`entry` after that takes no lock
_entries: Dict[Tuple[str, str], Callable[..., int]] = {}


def entry(source: str, name: str) -> Callable[..., int]:
    fn = _entries.get((source, name))
    if fn is None:
        fn = _entries[(source, name)] = getattr(load(source), name)
    return fn
