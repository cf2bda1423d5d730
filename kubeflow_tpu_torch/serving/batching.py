"""Dynamic request batching: coalesce concurrent predicts into one forward.

The port's copy of ``kubeflow_tpu/serving/batching.py``, behind
``ModelServer(batching=True)``. Mechanics:

- requests enqueue and block; one worker drains the queue,
- the worker waits up to ``max_wait_ms`` for more work (latency bound) or
  until ``max_batch`` rows accumulate (the largest serving bucket),
- one padded forward runs; each request gets exactly its rows back,
- a failed batch fails only the requests in it.

The combined batch pads to the same bucket ladder the unbatched path uses
(``serving/server.py`` ``BATCH_BUCKETS``): on the card N coalesced rows
cost one forward's launches instead of N forwards'.
"""

from __future__ import annotations

import threading
import time
from dataclasses import dataclass, field
from typing import Any, List, Optional, Sequence

import numpy as np

from ..runtime.metrics import METRICS
from .errors import DeadlineExceeded


class BatcherClosed(RuntimeError):
    """The batcher was shut down (model reload/unload) — retry unbatched."""


#: coalescing-window waits are ms-scale (max_wait_ms default 5) but a
#: busy queue can push them to seconds — same ladder as the engine's
QUEUE_WAIT_BUCKETS = (0.001, 0.005, 0.01, 0.05, 0.1, 0.5, 1.0, 5.0, 15.0,
                      60.0)


@dataclass
class _Pending:
    instances: Sequence[Any]
    shape_sig: Any  # (per-instance shape, dtype) — only like-shaped requests co-batch
    done: threading.Event = field(default_factory=threading.Event)
    result: Optional[List[Any]] = None
    error: Optional[BaseException] = None
    waited: bool = False  # sat through a full coalescing window already
    enqueued_at: float = field(default_factory=time.perf_counter)
    deadline: Optional[float] = None  # absolute time.monotonic(); None = none


class DynamicBatcher:
    """Wraps a ``predict(instances) -> results`` callable with coalescing.

    ``max_batch`` bounds the combined row count (use the model's largest
    batch bucket); ``max_wait_ms`` bounds added latency for the first
    request in a batch.
    """

    def __init__(
        self,
        predict_fn,
        max_batch: int = 64,
        max_wait_ms: float = 5.0,
        name: str = "model",
    ):
        self.predict_fn = predict_fn
        self.max_batch = max_batch
        self.max_wait_s = max_wait_ms / 1000.0
        self.name = name
        self._lock = threading.Condition()
        self._queue: List[_Pending] = []
        self._closed = False
        self._worker = threading.Thread(
            target=self._run, name=f"batcher-{name}", daemon=True
        )
        self._worker.start()

    # -- client side ---------------------------------------------------------
    @staticmethod
    def _signature(instances: Sequence[Any]):
        """Per-instance (shape, dtype); raises ValueError for ragged input so
        a malformed request fails ALONE, never inside someone else's batch.

        Returns ``None`` for object-dtype input (list-of-dict instances for
        models with a preprocess fn, or ragged nests numpy tolerates as
        object arrays): such requests have no usable structural signature,
        so co-batching them would let one malformed request fail strangers'
        requests — they serve unbatched instead."""
        arr = np.asarray(instances)  # raises on inhomogeneous shapes
        if arr.dtype == object:
            return None
        return arr.shape[1:], str(arr.dtype)

    def predict(self, instances: Sequence[Any],
                deadline: Optional[float] = None) -> List[Any]:
        """``deadline`` (absolute ``time.monotonic()``): an expired pending
        is shed from the queue without ever joining a forward, and the
        caller's wait is bounded by the deadline instead of being
        indefinite."""
        if len(instances) >= self.max_batch:
            # Oversized requests run alone — no point queueing behind them
            # (and no point paying for a signature they won't use).
            return self.predict_fn(instances)
        sig = self._signature(instances)
        if sig is None:
            # Unsignaturable (object-dtype) requests also run alone.
            return self.predict_fn(instances)
        pending = _Pending(instances, sig, deadline=deadline)
        with self._lock:
            if self._closed:
                raise BatcherClosed("batcher closed")
            self._queue.append(pending)
            self._lock.notify()
        timeout = None
        if deadline is not None:
            # grace past the deadline: an in-forward batch finishes and
            # returns real results rather than racing the shed
            timeout = max(0.0, deadline - time.monotonic()) + 1.0
        if not pending.done.wait(timeout):
            raise DeadlineExceeded("request missed its deadline in the "
                                   "batching queue")
        if pending.error is not None:
            raise pending.error
        return pending.result  # type: ignore[return-value]

    def close(self) -> None:
        with self._lock:
            self._closed = True
            # Wake EVERY condition waiter, not just one: with notify() the
            # single wakeup can land on a thread that re-waits (a future
            # multi-waiter worker, or a straggler mid-window) and the rest
            # sleep through shutdown.
            self._lock.notify_all()
        self._worker.join(timeout=5)
        # The worker drains the queue before exiting; if it died or the
        # join timed out (predict_fn wedged), fail the leftovers instead
        # of leaving their callers blocked on done.wait() forever.
        with self._lock:
            leftover, self._queue = self._queue, []
        for p in leftover:
            if not p.done.is_set():
                p.error = BatcherClosed("batcher closed before serving request")
                p.done.set()

    def drain(self, timeout: float = 60.0) -> None:
        """Graceful shutdown, distinct from ``close()``: stop admission
        (predict raises BatcherClosed) but let the worker SERVE everything
        already queued before it exits — close() instead fails leftovers.
        Safe to call close() afterwards (idempotent no-op)."""
        with self._lock:
            self._closed = True
            self._lock.notify_all()
        # the worker's loop exits only once the queue is empty
        # (_take_batch returns [] when closed AND drained), so a plain
        # join is the "finish in-flight" barrier
        self._worker.join(timeout=timeout)
        with self._lock:
            leftover, self._queue = self._queue, []
        for p in leftover:  # worker wedged past the timeout: fail, don't hang
            if not p.done.is_set():
                p.error = BatcherClosed("batcher drain timed out")
                p.done.set()

    # -- worker side ---------------------------------------------------------
    def _shed_expired_locked(self) -> None:
        """Fail queued pendings whose deadline passed — they never join a
        forward (fail fast, keep the batch for live requests). Caller
        holds the lock."""
        now = time.monotonic()
        live: List[_Pending] = []
        for p in self._queue:
            if p.deadline is not None and now >= p.deadline:
                METRICS.counter("serving_deadline_expired_total",
                                stage="queued").inc()
                p.error = DeadlineExceeded(
                    "deadline expired while queued for batching")
                p.done.set()
            else:
                live.append(p)
        self._queue = live

    def _take_batch(self) -> List[_Pending]:
        with self._lock:
            while True:
                self._shed_expired_locked()
                if self._queue:
                    break
                if self._closed:
                    return []
                self._lock.wait()
            # A head pending that already sat through a full window (left
            # over from a mixed-shape round) serves immediately; fresh
            # arrivals get the normal coalescing window.
            if not self._queue[0].waited:
                deadline = time.monotonic() + self.max_wait_s
                while True:
                    rows = sum(len(p.instances) for p in self._queue)
                    remaining = deadline - time.monotonic()
                    if rows >= self.max_batch or remaining <= 0 or self._closed:
                        break
                    self._lock.wait(remaining)
                for p in self._queue:
                    p.waited = True
            # Take like-shaped pendings only (mixed shapes cannot share one
            # array), up to max_batch rows. Every queued pending has
            # < max_batch rows, so this always takes at least one; other
            # shapes stay queued for the next round.
            batch: List[_Pending] = []
            rows = 0
            sig = self._queue[0].shape_sig
            remaining_queue: List[_Pending] = []
            for p in self._queue:
                if p.shape_sig == sig and rows + len(p.instances) <= self.max_batch:
                    batch.append(p)
                    rows += len(p.instances)
                else:
                    remaining_queue.append(p)
            self._queue = remaining_queue
            return batch

    def _run(self) -> None:
        while True:
            batch = self._take_batch()
            if not batch:
                return
            combined: List[Any] = []
            started = time.perf_counter()
            for p in batch:
                combined.extend(p.instances)
                # enqueue→forward-start wait: the coalescing window plus any
                # time spent queued behind other shapes
                METRICS.histogram(
                    "serving_batch_queue_wait_seconds",
                    buckets=QUEUE_WAIT_BUCKETS, model=self.name,
                ).observe(started - p.enqueued_at)
            try:
                results = self.predict_fn(combined)
                if len(results) != len(combined):
                    raise RuntimeError(
                        f"predict returned {len(results)} results for {len(combined)} rows"
                    )
                offset = 0
                for p in batch:
                    p.result = list(results[offset : offset + len(p.instances)])
                    offset += len(p.instances)
                METRICS.counter("serving_batches_total", model=self.name).inc()
                METRICS.histogram("serving_batch_rows", model=self.name).observe(len(combined))
            except Exception as e:  # the batch's failure, routed to its callers
                for p in batch:
                    p.error = e
            finally:
                for p in batch:
                    p.done.set()
