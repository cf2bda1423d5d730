"""Prefetching input pipeline: the port of ``kubeflow_tpu/data/pipeline.py``.

- A background thread pulls batches from the (CPU-bound) source and copies
  them to the device, so the host-to-device copy of batch N+1 overlaps the
  compute of batch N. On a CUDA device each numpy leaf is staged in a
  pinned host buffer and copied with ``non_blocking`` on a side
  ``torch.cuda.Stream``; the producer waits for that copy before it
  refills the buffer, so a pinned buffer is never overwritten while its
  copy reads it. The consumer makes its current stream wait on the copy's
  event and calls ``record_stream`` on each tensor it yields, so the
  caching allocator does not hand the side stream's block to a later
  allocation while the consumer's stream still reads it.
- A bounded buffer (default 2: double buffering) keeps host memory flat
  while hiding host latency spikes.
- Multi-host: each process feeds only its rows of the global batch
  (``per_host_shard``, from ``RANK`` and ``WORLD_SIZE`` in place of
  ``jax.process_*``).

On a CPU device it is the same queue with plain copies. ``device`` takes
the place of JAX's ``sharding``; a CUDA device on a host without CUDA
raises.
"""

from __future__ import annotations

import itertools
import os
import queue
import threading
from typing import Any, Callable, Dict, Iterable, Iterator, Optional, Tuple

import numpy as np
import torch

from ..device import DeviceLike, resolve_device
from ..gpu.env import ENV_RANK, ENV_WORLD_SIZE


def per_host_shard(global_batch: int, *, process_index: Optional[int] = None,
                   process_count: Optional[int] = None) -> Tuple[int, int]:
    """(start, size) of this process's rows in the global batch: which
    examples its reader must produce. The process index and count default
    to the torchrun environment's ``RANK`` and ``WORLD_SIZE``
    (``gpu/env.py``; 0 and 1 when unset)."""
    pi = int(os.environ.get(ENV_RANK, "0")) if process_index is None else process_index
    pc = int(os.environ.get(ENV_WORLD_SIZE, "1")) if process_count is None else process_count
    if global_batch % pc != 0:
        raise ValueError(f"global batch {global_batch} not divisible by {pc} hosts")
    size = global_batch // pc
    return pi * size, size


def _map(fn: Callable[[Any], Any], item: Any) -> Any:
    """``fn`` over the leaves of a dict/list/tuple tree."""
    if isinstance(item, dict):
        return {k: _map(fn, v) for k, v in item.items()}
    if isinstance(item, (list, tuple)):
        return type(item)(_map(fn, v) for v in item)
    return fn(item)


def _host_tensor(leaf: Any) -> torch.Tensor:
    if isinstance(leaf, torch.Tensor):
        return leaf.detach()
    return torch.from_numpy(np.ascontiguousarray(leaf))


class _CudaStaging:
    """The producer's copy path to a CUDA device: a pinned buffer per leaf
    position, reused while the leaf's shape and dtype hold, and a side
    stream for the copies."""

    def __init__(self, device: torch.device) -> None:
        self.device = device
        self.stream = torch.cuda.Stream(device=device)
        self.pinned: Dict[int, torch.Tensor] = {}

    def _copy(self, i: int, leaf: Any) -> torch.Tensor:
        src = _host_tensor(leaf)
        buf = self.pinned.get(i)
        if buf is None or buf.shape != src.shape or buf.dtype != src.dtype:
            buf = self.pinned[i] = torch.empty(src.shape, dtype=src.dtype, pin_memory=True)
        buf.copy_(src)
        return buf.to(self.device, non_blocking=True)

    def __call__(self, item: Any) -> Tuple[Any, torch.cuda.Event]:
        index = itertools.count()
        with torch.cuda.stream(self.stream):
            out = _map(lambda leaf: self._copy(next(index), leaf), item)
            done = torch.cuda.Event()
            done.record(self.stream)
        # the pinned buffers are refilled by the next item: wait for these
        # copies first (this thread only; the consumer's stream runs on)
        done.synchronize()
        return out, done


def device_prefetch(source: Iterable[Any], device: DeviceLike = "cuda",
                    buffer_size: int = 2, clock: Optional[Any] = None) -> Iterator[Any]:
    """Iterate ``source`` with its items copied to ``device`` on a
    background thread, ``buffer_size`` deep.

    Each item is a dict/list/tuple tree (or a single leaf) of numpy arrays
    or tensors; it comes out as the same tree of tensors on ``device``, in
    order. ``clock`` (a ``gpu.profiling.StepClock``) charges the consumer's
    queue wait to its ``data_wait`` phase: zero while prefetch keeps up,
    the input-bound signal when it does not. A source's error is raised on
    the consumer's side; closing the iterator early releases the
    producer."""
    return _prefetch(source, resolve_device(device), buffer_size, clock)


def _prefetch(source: Iterable[Any], dev: torch.device, buffer_size: int,
              clock: Optional[Any]) -> Iterator[Any]:
    q: "queue.Queue[Any]" = queue.Queue(maxsize=max(1, buffer_size))
    end = object()
    error: list = []
    stop = threading.Event()
    staging = _CudaStaging(dev) if dev.type == "cuda" else None

    def put(item: Any) -> bool:
        while not stop.is_set():
            try:
                q.put(item, timeout=0.1)
                return True
            except queue.Full:
                continue
        return False

    def produce() -> None:
        try:
            if staging is not None:
                torch.cuda.set_device(dev)
            for item in source:
                if stop.is_set():
                    return
                if staging is not None:
                    placed = staging(item)
                else:
                    placed = (_map(lambda leaf: _host_tensor(leaf).to(dev, copy=True), item),
                              None)
                if not put(placed):
                    return
        except BaseException as e:  # raised again on the consumer's side
            error.append(e)
        finally:
            put(end)

    t = threading.Thread(target=produce, name="data-prefetch", daemon=True)
    t.start()
    try:
        while True:
            if clock is not None:
                with clock.data_wait():
                    got = q.get()
            else:
                got = q.get()
            if got is end:
                if error:
                    raise error[0]
                return
            item, done = got
            if done is not None:
                stream = torch.cuda.current_stream(dev)
                stream.wait_event(done)
                _map(lambda x: x.record_stream(stream), item)
            yield item
    finally:
        # abandoned mid-epoch (break / GeneratorExit): release the producer;
        # it must not stay blocked on a full queue holding device buffers
        stop.set()
        while True:
            try:
                q.get_nowait()
            except queue.Empty:
                break


class DataPipeline:
    """Source → (optional) transform → prefetched batches on ``device``.

    ``source_fn(epoch)`` returns an iterable of batches, so epochs can
    reshuffle; ``transform`` runs on the producer thread (augmentation,
    casting)."""

    def __init__(self, source_fn: Callable[[int], Iterable[Any]], device: DeviceLike = "cuda",
                 transform: Optional[Callable[[Any], Any]] = None, buffer_size: int = 2,
                 clock: Optional[Any] = None):
        self.source_fn = source_fn
        self.device = resolve_device(device)
        self.transform = transform
        self.buffer_size = buffer_size
        self.clock = clock

    def epoch(self, epoch: int = 0) -> Iterator[Any]:
        source: Iterable[Any] = self.source_fn(epoch)
        if self.transform is not None:
            transform = self.transform
            source = (transform(item) for item in source)
        return device_prefetch(source, self.device, self.buffer_size, clock=self.clock)

    def __iter__(self) -> Iterator[Any]:
        return self.epoch(0)


def synthetic_classifier_source(batch: int, image_shape: Tuple[int, ...] = (224, 224, 3),
                                num_classes: int = 1000, steps: int = 100, seed: int = 0
                                ) -> Callable[[int], Iterable[Any]]:
    """Deterministic synthetic (images, labels) batches: bench and smoke data
    with no I/O, the same numpy arrays as the JAX package's."""

    def source(epoch: int):
        rng = np.random.default_rng(seed + epoch)
        for _ in range(steps):
            yield {
                "images": rng.standard_normal((batch, *image_shape), dtype=np.float32),
                "labels": rng.integers(0, num_classes, size=(batch,), dtype=np.int32),
            }

    return source
