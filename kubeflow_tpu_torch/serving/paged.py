"""Paged KV-cache block accounting for the continuous-batching engine.

A copy of ``kubeflow_tpu/serving/paged.py``. The paged layout keeps ONE
shared arena of fixed-size blocks per layer (``[n_blocks + 1, block_t,
heads, head_dim]`` — the last row is the trash block) and a host-side
per-slot block table mapping absolute positions to arena rows. This module
owns the host-side half: the free-list allocator that reserves capacity at
admission and grants physical blocks as cursors advance, published as
``serving_kv_blocks_{free,used}`` gauges.

Two-phase accounting (reserve → grant):

- **reserve** happens at admission and covers the request's worst case
  (``ceil((prompt + budget) / block_t)`` blocks). If the arena cannot
  promise the blocks, the request stays pending (:class:`KVBlocksExhausted`
  is a :class:`~kubeflow_tpu_torch.serving.errors.FleetSaturated`) — a
  granted write can never be redirected into another slot's data.
- **grant** happens just before each dispatch and only up to the cursor
  frontier that dispatch will reach. Until granted, the slot's table
  entries point at the trash block.

The device-side contract lives in ``kubeflow_tpu_torch/ops/kv_cache.py``
(trash-block convention) and ``serving/continuous.py`` (retire ordering:
table row → trash BEFORE blocks return to the free list).
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import List

from ..runtime.metrics import METRICS
from .errors import FleetSaturated


class KVBlocksExhausted(FleetSaturated):
    """The arena cannot reserve the blocks a request needs right now.

    Subclasses :class:`FleetSaturated` on purpose: exhaustion is admission
    back-pressure, not corruption — the engine keeps the request pending
    and retries as retirements return blocks, and if it must give up the
    HTTP layer already maps FleetSaturated to 503 + Retry-After.
    """


@dataclass
class KVReservation:
    """One slot's promised block budget: ``total`` blocks reserved, of
    which ``granted`` have been popped off the free list (in position
    order — ``granted[i]`` backs positions ``[i*block_t, (i+1)*block_t)``).
    """
    total: int
    granted: List[int] = field(default_factory=list)


class KVBlockAllocator:
    """LIFO free-list allocator over ``n_blocks`` arena rows.

    Row ``n_blocks`` (the arena's last row — callers allocate
    ``n_blocks + 1`` rows) is the trash block and is never handed out;
    :attr:`trash` exposes its id for table initialization.
    """

    def __init__(self, n_blocks: int, block_t: int, *, engine_id: str = "0"):
        if n_blocks <= 0:
            raise ValueError(f"need at least one KV block, got {n_blocks}")
        self.n_blocks = int(n_blocks)
        self.block_t = int(block_t)
        self.trash = self.n_blocks
        self.engine_id = engine_id
        self._free: List[int] = list(range(self.n_blocks))
        self._promised = 0  # reserved but not yet granted
        self._publish()

    # -- accounting ---------------------------------------------------------

    def available(self) -> int:
        """Blocks that can still be promised to new reservations."""
        return len(self._free) - self._promised

    def used(self) -> int:
        """Blocks physically granted (out of the free list)."""
        return self.n_blocks - len(self._free)

    def blocks_for(self, tokens: int) -> int:
        """Blocks needed to back ``tokens`` positions."""
        return -(-int(tokens) // self.block_t)

    # -- lifecycle ----------------------------------------------------------

    def reserve(self, n_blocks: int) -> KVReservation:
        """Promise ``n_blocks`` to one request or raise
        :class:`KVBlocksExhausted`. Impossible requests (bigger than the
        whole arena) raise ValueError — waiting would never help."""
        if n_blocks > self.n_blocks:
            raise ValueError(
                f"request needs {n_blocks} KV blocks but the arena only has "
                f"{self.n_blocks}; raise kv_blocks or shrink the request")
        if n_blocks > self.available():
            raise KVBlocksExhausted(
                f"KV arena exhausted: need {n_blocks} blocks, "
                f"{self.available()} available of {self.n_blocks}",
                retry_after_s=0.05)
        self._promised += n_blocks
        return KVReservation(total=n_blocks)

    def grant(self, res: KVReservation, upto_blocks: int) -> List[int]:
        """Materialize the reservation up to ``upto_blocks`` granted blocks
        (capped at ``res.total``); returns only the newly granted ids, in
        position order."""
        upto_blocks = min(upto_blocks, res.total)
        newly: List[int] = []
        while len(res.granted) < upto_blocks:
            blk = self._free.pop()
            self._promised -= 1
            res.granted.append(blk)
            newly.append(blk)
        if newly:
            self._publish()
        return newly

    def release(self, res: KVReservation) -> None:
        """Return a reservation's blocks (granted and promised) to the
        free list. The caller MUST have redirected the slot's table row to
        trash before calling this (retire ordering invariant)."""
        self._free.extend(res.granted)
        self._promised -= res.total - len(res.granted)
        res.granted = []
        res.total = 0
        self._publish()

    def _publish(self) -> None:
        METRICS.gauge("serving_kv_blocks_free",
                      replica=self.engine_id).set(len(self._free))
        METRICS.gauge("serving_kv_blocks_used",
                      replica=self.engine_id).set(self.used())
