"""KV-write strategies and the decode chunk's cost, measured on the card.

The port of ``e2e/kv_update_probe.py``. Three measurements:

- :func:`isolated`: one decode step's KV write, alone. At the JAX probe's
  contiguous cache ``[8, 352, 16, 64]`` bf16: a where-select over the whole
  cache, one ``index_put_`` and one ``kv_row_update`` call; then one
  layer's K and V as two ``kv_row_update`` calls, one ``kv_row_update_pair``
  call, and two launches of the design the pair replaced (the one-array
  kernel, through ``kv_row_update_cfg``). At GPT-small's paged serving
  shapes (8 slots, arena ``[8 * 128 + 1, 16, 12, 64]`` bf16, ``max_seq``
  2048): the same three for the paged write (``kv_block_update``,
  ``kv_block_update_pair``, ``kv_block_update_cfg``).
- :func:`in_model`: the GPT decode chunk (16 single-token steps, the JAX
  probe's GPT-medium-class config at ``max_seq`` 352, 8 slots) in ms per
  token: shared cursor, per-slot with the KV writes plain and through the
  kernels, in the contiguous cache and in the paged arena.
- :func:`host_split`: where a KV-write call's host time goes, part by part
  (``time.perf_counter_ns`` over many calls of each part alone).

Times are CUDA events around back-to-back calls (``ceiling.timed``), or the
host clock around work that ends in a synchronize: PyTorch's launches
return before the device finishes, so no host fetch is needed to order
them. On the CPU (``device="cpu"``, toy shapes) the wrappers run their
plain versions and the times are the CPU's: no device metric.

Run on the card: ``python -m kubeflow_tpu_torch.e2e.kv_update_probe``.
"""

from __future__ import annotations

import argparse
import json
import statistics
import time
from typing import Any, Callable, Dict, Optional

import torch

from ..device import DeviceLike, resolve_device
from ..ops import _build
from ..ops import kv_cache as kc
from ..ops.kv_cache import _raw_stream
from .ceiling import timed

#: the JAX probe's contiguous cache: slots, positions, heads, head_dim
CONTIG = (8, 352, 16, 64)
#: GPT-small's paged serving arena: slots, max_seq, heads, head_dim, block_t
PAGED = (8, 2048, 12, 64, 16)
CHUNK = 16


def _ms(fn: Callable[[], Any], iters: int, device: torch.device) -> float:
    return timed(fn, iters, warmup=3, device=device) * 1e3


def isolated(contig=CONTIG, paged=PAGED, iters: int = 200,
             device: DeviceLike = "cuda") -> Dict[str, Optional[float]]:
    """ms per call of each write (see the module docstring). Every cursor
    is in range, as in the JAX probe. The ``*_replaced_x2_ms`` rows are None
    on the CPU: the replaced kernels have no plain version of their own."""
    dev = resolve_device(device)
    g = torch.Generator().manual_seed(0)
    S, T, H, D = contig
    cache = torch.randn(S, T, H, D, generator=g).to(dev, torch.bfloat16)
    new = torch.randn(S, H, D, generator=g).to(dev, torch.bfloat16)
    cur = torch.randint(0, T, (S,), generator=g, dtype=torch.int32).to(dev)
    rows, cur_l = torch.arange(S, device=dev), cur.long()
    at = torch.arange(T, device=dev)[None, :, None, None] == cur_l[:, None, None, None]
    out: Dict[str, Optional[float]] = {
        "where_select_ms": _ms(lambda: torch.where(at, new[:, None], cache), iters, dev),
        "index_put_ms": _ms(lambda: cache.index_put_((rows, cur_l), new), iters, dev),
        "kv_row_update_ms": _ms(lambda: kc.kv_row_update(cache, new, cur), iters, dev),
    }
    v_cache = torch.randn(S, T, H, D, generator=g).to(dev, torch.bfloat16)
    v_new = torch.randn(S, H, D, generator=g).to(dev, torch.bfloat16)

    def two_rows():
        kc.kv_row_update(cache, new, cur)
        kc.kv_row_update(v_cache, v_new, cur)

    out["kv_row_update_x2_ms"] = _ms(two_rows, iters, dev)
    out["kv_row_update_pair_ms"] = _ms(
        lambda: kc.kv_row_update_pair(cache, v_cache, new, v_new, cur), iters, dev)
    out["row_replaced_x2_ms"] = None
    if dev.type == "cuda":
        out["row_replaced_x2_ms"] = _ms(
            lambda: kc.kv_row_update_cfg(0, cache, v_cache, new, v_new, cur), iters, dev)

    S, max_seq, H, D, bt = paged
    mb = max_seq // bt
    arenas = [torch.randn(S * mb + 1, bt, H, D, generator=g).to(dev, torch.bfloat16)
              for _ in range(2)]
    k, v = (torch.randn(S, H, D, generator=g).to(dev, torch.bfloat16) for _ in range(2))
    cur = torch.randint(0, max_seq, (S,), generator=g, dtype=torch.int32).to(dev)
    tables = torch.randperm(S * mb, generator=g).view(S, mb).int().to(dev)

    def two_single():
        kc.kv_block_update(arenas[0], k, cur, tables, max_seq=max_seq)
        kc.kv_block_update(arenas[1], v, cur, tables, max_seq=max_seq)

    out["kv_block_update_x2_ms"] = _ms(two_single, iters, dev)
    out["kv_block_update_pair_ms"] = _ms(
        lambda: kc.kv_block_update_pair(*arenas, k, v, cur, tables, max_seq=max_seq),
        iters, dev)
    out["block_replaced_x2_ms"] = None
    if dev.type == "cuda":
        out["block_replaced_x2_ms"] = _ms(
            lambda: kc.kv_block_update_cfg(0, *arenas, k, v, cur, tables, max_seq=max_seq),
            iters, dev)
    return out


def medium_config(dtype: torch.dtype = torch.bfloat16):
    """The JAX probe's GPT-medium-class config at its short ``max_seq``."""
    from ..models.gpt import GptConfig

    return GptConfig(d_model=1024, n_layers=24, n_heads=16, d_ff=4096,
                     max_seq=CONTIG[1], vocab_size=32000, dtype=dtype)


def in_model(cfg=None, slots: int = CONTIG[0], chunks: int = 5, start: int = 128,
             device: DeviceLike = "cuda") -> Dict[str, float]:
    """ms per decode token of a 16-step chunk, from position ``start``. Each
    row's time is the median of ``chunks`` chunks after one warm-up chunk
    (host clock, each chunk ending in a synchronize). The rows take turns,
    one chunk each a round, so a drift in the host's speed reaches every
    row alike."""
    from ..models.gpt import GptLM, init_params

    dev = resolve_device(device)
    cfg = cfg or medium_config()
    params = init_params(cfg, seed=0, device=dev)
    bt = 16 if cfg.max_seq % 16 == 0 else 1
    mb = cfg.max_seq // bt
    kv = (slots, cfg.max_seq, cfg.n_heads, cfg.head_dim)
    arena = (slots * mb + 1, bt, cfg.n_heads, cfg.head_dim)
    tables = torch.arange(slots * mb, dtype=torch.int32, device=dev).view(slots, mb)

    def cache(per_slot: bool, paged: bool):
        def layer():
            if paged:
                return {"k_arena": torch.zeros(arena, dtype=cfg.dtype, device=dev),
                        "v_arena": torch.zeros(arena, dtype=cfg.dtype, device=dev),
                        "cursors": torch.full((slots,), start, dtype=torch.int32,
                                              device=dev)}
            c = {"k": torch.zeros(kv, dtype=cfg.dtype, device=dev),
                 "v": torch.zeros(kv, dtype=cfg.dtype, device=dev)}
            if per_slot:
                c["cursors"] = torch.full((slots,), start, dtype=torch.int32, device=dev)
            else:
                c["cursor"] = torch.full((), start, dtype=torch.int32, device=dev)
            return c
        return {f"block_{i}": {"attention": layer()} for i in range(cfg.n_layers)}

    rows = {"shared_cursor": dict(per_slot=False, paged=False, kv_kernel=False),
            "per_slot_plain": dict(per_slot=True, paged=False, kv_kernel=False),
            "per_slot_kernel": dict(per_slot=True, paged=False, kv_kernel=True),
            "paged_plain": dict(per_slot=True, paged=True, kv_kernel=False),
            "paged_kernel": dict(per_slot=True, paged=True, kv_kernel=True)}
    runs = {}
    with torch.no_grad():
        for name, mode in rows.items():
            model = GptLM.bind(cfg, params, decode=True, **mode)
            runs[name] = (model, cache(mode["per_slot"], mode["paged"]),
                          tables if mode["paged"] else None)

        def chunk(name):
            model, c, bt_arg = runs[name]
            tok = torch.zeros((slots,), dtype=torch.int32, device=dev)
            t0 = time.perf_counter()
            for _ in range(CHUNK):
                logits = model(tok[:, None], c, block_tables=bt_arg)
                tok = torch.argmax(logits[:, -1], dim=-1).to(torch.int32)
            if dev.type == "cuda":
                torch.cuda.synchronize(dev)
            return (time.perf_counter() - t0) * 1e3

        for name in runs:
            chunk(name)
        times = {name: [] for name in runs}
        for _ in range(chunks):
            for name in runs:
                times[name].append(chunk(name))
    out: Dict[str, float] = {}
    for name, ms in times.items():
        out[f"{name}_ms_per_chunk"] = statistics.median(ms)
        out[f"{name}_ms_per_token"] = statistics.median(ms) / CHUNK
    return out


def time_parts(parts: Dict[str, Callable[[], Any]], n: int = 10_000) -> Dict[str, float]:
    """Host µs per call of each part: ``n`` calls in a loop between two
    ``time.perf_counter_ns`` reads, after ``n // 10`` warm-up calls."""
    out = {}
    for name, fn in parts.items():
        for _ in range(n // 10):
            fn()
        t0 = time.perf_counter_ns()
        for _ in range(n):
            fn()
        out[name] = (time.perf_counter_ns() - t0) / n / 1e3
    return out


def host_split(paged=PAGED, n: int = 10_000, device: DeviceLike = "cuda") -> Dict[str, float]:
    """Host µs per call of a KV write and of each part of its path, paged
    and contiguous (GPT-small's caches ``[8, 2048, 12, 64]``): the whole
    wrappers; the checks; the int32 casts the wrappers skip when
    the tensors already are int32 and contiguous; the stream lookup (the
    public ``current_stream`` and the raw one); ``_build.entry``, and a bare
    lock round trip beside it; the ctypes calls themselves (the C entry's
    device check and launch included) and the empty kernel's (the least a
    ctypes launch costs). The device runs every launch; the queue is
    drained between parts."""
    import threading

    dev = resolve_device(device)
    S, max_seq, H, D, bt = paged
    mb = max_seq // bt
    g = torch.Generator().manual_seed(0)
    arenas = [torch.zeros(S * mb + 1, bt, H, D, dtype=torch.bfloat16, device=dev)
              for _ in range(2)]
    k, v = (torch.randn(S, H, D, generator=g).to(dev, torch.bfloat16) for _ in range(2))
    cur = torch.randint(0, max_seq, (S,), generator=g, dtype=torch.int32).to(dev)
    tables = torch.randperm(S * mb, generator=g).view(S, mb).int().to(dev)
    caches = [torch.zeros(S, max_seq, H, D, dtype=torch.bfloat16, device=dev)
              for _ in range(2)]
    idx = arenas[0].get_device()
    row_bytes = H * D * 2
    lock = threading.Lock()

    def locked():
        with lock:
            pass

    stream = _raw_stream(idx)
    floor = _build.entry(kc.SOURCE, "kv_launch_floor")
    pair = _build.entry(kc.SOURCE, "kv_block_update_pair")
    args = (idx, *(a.data_ptr() for a in arenas), k.data_ptr(), v.data_ptr(), 2,
            cur.data_ptr(), tables.data_ptr(), S, mb, bt, max_seq, S * mb + 1, row_bytes,
            stream)
    row_pair = _build.entry(kc.SOURCE, "kv_row_update_pair")
    row_args = (idx, *(c.data_ptr() for c in caches), k.data_ptr(), v.data_ptr(), 2,
                cur.data_ptr(), S, max_seq, row_bytes, stream)
    parts: Dict[str, Callable[[], Any]] = {
        "kv_block_update": lambda: kc.kv_block_update(arenas[0], k, cur, tables,
                                                      max_seq=max_seq),
        "kv_block_update_pair": lambda: kc.kv_block_update_pair(
            *arenas, k, v, cur, tables, max_seq=max_seq),
        "kv_row_update": lambda: kc.kv_row_update(caches[0], k, cur),
        "kv_row_update_pair": lambda: kc.kv_row_update_pair(*caches, k, v, cur),
        "checks (paged pair)": lambda: kc._check_write("kv_block_update_pair", arenas,
                                                       (k, v), cur, tables),
        "checks (contiguous pair)": lambda: kc._check_write("kv_row_update_pair", caches,
                                                            (k, v), cur),
        "int32 casts x2 (.to().contiguous())": lambda: (
            cur.to(torch.int32).contiguous(), tables.to(torch.int32).contiguous()),
        "int32 casts x2 (skipped)": lambda: (kc._i32(cur), kc._i32(tables)),
        "current_stream().cuda_stream": (
            lambda: torch.cuda.current_stream(arenas[0].device).cuda_stream),
        "raw current stream": lambda: _raw_stream(idx),
        "_build.entry": lambda: _build.entry(kc.SOURCE, "kv_launch_floor"),
        "lock round trip": locked,
        "ctypes kv_launch_floor (4 args)": lambda: floor(idx, S, row_bytes, stream),
        f"ctypes kv_block_update_pair ({len(args)} args)": lambda: pair(*args),
        f"ctypes kv_row_update_pair ({len(row_args)} args)": lambda: row_pair(*row_args),
    }
    out = {}
    for name, fn in parts.items():
        out.update(time_parts({name: fn}, n))
        torch.cuda.synchronize(dev)
    return out


def main(argv: Optional[list] = None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--no-model", action="store_true", help="skip in_model()")
    args = ap.parse_args(argv)
    _build.load(kc.SOURCE)
    iso = isolated()
    for name, ms in iso.items():
        print(f"  {name:28s} {ms:9.5f} ms")
    split = host_split()
    for name, us in split.items():
        print(f"  {name:45s} {us:8.3f} us")
    model = {} if args.no_model else in_model()
    for name, ms in model.items():
        print(f"  {name:32s} {ms:9.3f}")
    print(json.dumps({"metric": "kv_update_probe", "device": torch.cuda.get_device_name(),
                      "isolated": iso, "host_split_us": split, "in_model": model}))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
