"""Prefix-aware fleet router — the port of ``kubeflow_tpu/serving/router.py``.

Sits between the HTTP predict dispatch and the engine replicas. Two
policies, in order:

- ``prefix``: a request whose prompt prefix hashes to a prefix a replica
  served recently goes back to THAT replica, where that prefix's state is
  warm;
- ``least_loaded``: otherwise (or when the prefix owner is saturated) the
  ready replica with the lowest live load score, read off the
  ``serving_queue_depth`` / ``serving_slot_occupancy`` gauges each engine
  publishes under its ``replica`` label: the router keeps no shadow
  accounting.

When EVERY ready replica is saturated (queue depth at or past the
priority's depth limit) the router refuses with :class:`FleetSaturated`,
which the HTTP layer maps to 503 with a ``Retry-After``.

Pure Python over the port's metrics registry; the same keys, policies,
counters and hints as the JAX router, so both route a scripted sequence
alike (``tests/test_torch_router.py``).
"""

from __future__ import annotations

import zlib
from collections import OrderedDict
from typing import Optional, Sequence, Tuple

import numpy as np

from ..runtime.metrics import METRICS
from .errors import FleetSaturated

#: tokens hashed into the affinity key
DEFAULT_PREFIX_LEN = 16

#: per-replica LRU of prefix keys assumed warm
PREFIX_CACHE_SIZE = 512

#: Retry-After hint bounds: never "0" (a client would hammer), never more
#: than a minute (the autoscaler acts well before that)
RETRY_AFTER_MIN_S = 0.5
RETRY_AFTER_MAX_S = 60.0


def prefix_key(prompt_ids: Sequence[int], prefix_len: int = DEFAULT_PREFIX_LEN,
               model_id: str = "") -> int:
    """crc32 of the first ``prefix_len`` token ids as int32 bytes, seeded
    with the crc32 of ``model_id``: stable across processes, and
    multiplexed models never share a key (``model_id=""`` is plain crc32)."""
    head = np.asarray(prompt_ids, np.int32).reshape(-1)[:prefix_len]
    return zlib.crc32(head.tobytes(), zlib.crc32(model_id.encode("utf-8")))


class PrefixRouter:
    """Routing policy over the fleet's replica handles.

    The fleet calls ``route(handles, prompt_ids)`` under its own lock and
    gets back ``(handle, policy)``. Handles expose ``id``, ``gauge_id`` (the
    ``replica`` gauge label), ``state``, ``model_id`` and ``prefixes`` (an
    OrderedDict LRU whose contents this router owns).
    """

    def __init__(self, prefix_len: int = DEFAULT_PREFIX_LEN,
                 max_queue_depth: int = 32,
                 prefix_cache_size: int = PREFIX_CACHE_SIZE,
                 interactive_reserve: float = 0.25,
                 registry=METRICS):
        self.prefix_len = int(prefix_len)
        self.max_queue_depth = int(max_queue_depth)
        self.prefix_cache_size = int(prefix_cache_size)
        # batch requests saturate at (1 - reserve) * max_queue_depth, so a
        # batch flood cannot take interactive's queue headroom
        self.interactive_reserve = min(max(float(interactive_reserve), 0.0), 1.0)
        self._registry = registry

    def depth_limit(self, priority: str) -> int:
        if priority == "batch":
            return max(1, int(self.max_queue_depth * (1.0 - self.interactive_reserve)))
        return self.max_queue_depth

    def retry_after_hint(self, handles: Sequence) -> float:
        """Seconds until the least-loaded queue plausibly drains: its depth
        times the mean observed request latency, clamped to
        [``RETRY_AFTER_MIN_S``, ``RETRY_AFTER_MAX_S``]; 0.5 s a request
        before any request has finished."""
        depth = min((self.queue_depth(h) for h in handles),
                    default=float(self.max_queue_depth))
        mean_s = self._registry.histogram("serving_request_seconds").mean
        if mean_s <= 0.0:
            mean_s = 0.5
        return min(RETRY_AFTER_MAX_S, max(RETRY_AFTER_MIN_S, depth * mean_s))

    def queue_depth(self, handle) -> float:
        return self._registry.value("serving_queue_depth", replica=handle.gauge_id)

    def load_score(self, handle) -> float:
        """Queued requests plus fractional slot occupancy: the queue
        dominates, occupancy breaks ties between empty queues."""
        return self.queue_depth(handle) + self._registry.value(
            "serving_slot_occupancy", replica=handle.gauge_id)

    def route(self, handles: Sequence, prompt_ids: Sequence[int],
              exclude: Optional[str] = None,
              priority: str = "interactive",
              model_id: str = "") -> Tuple[object, str]:
        """Pick a replica for ``prompt_ids``; returns ``(handle, policy)``.

        ``exclude`` drops one replica id (a drained replica's requests must
        not route back to it). ``priority`` picks the depth limit.
        ``model_id`` scopes both policies to one multiplexed model: handles
        of another model are dropped here whatever the caller passed."""
        ready = [h for h in handles
                 if h.state == "ready" and h.id != exclude
                 and getattr(h, "model_id", "") == model_id]
        if not ready:
            raise FleetSaturated("no ready replicas in the fleet")
        limit = self.depth_limit(priority)
        key = prefix_key(prompt_ids, self.prefix_len, model_id)
        owner = next((h for h in ready if key in h.prefixes), None)
        if owner is not None and self.queue_depth(owner) < limit:
            policy = "prefix"
            chosen = owner
            METRICS.counter("fleet_prefix_hits_total").inc()
        else:
            candidates = [h for h in ready if self.queue_depth(h) < limit]
            if not candidates:
                METRICS.counter("fleet_saturated_total").inc()
                METRICS.counter("serving_shed_total", priority=priority).inc()
                raise FleetSaturated(
                    f"all {len(ready)} ready replicas at max queue depth "
                    f"{limit} for priority={priority}",
                    retry_after_s=self.retry_after_hint(ready))
            # the owner existed but was saturated: a distinct label, so the
            # miss shows beside the hit counter
            policy = "prefix_spill" if owner is not None else "least_loaded"
            chosen = min(candidates, key=self.load_score)
        self._note_prefix(chosen, key)
        METRICS.counter("fleet_routed_total", policy=policy).inc()
        return chosen, policy

    def note_prefix(self, handle, prompt_ids: Sequence[int], model_id: str = "") -> None:
        """Record warm-prefix ownership outside :meth:`route`: a KV handoff
        moved a request's warm state to a replica the router did not pick."""
        self._note_prefix(handle, prefix_key(prompt_ids, self.prefix_len, model_id))

    def _note_prefix(self, handle, key: int) -> None:
        cache: "OrderedDict[int, None]" = handle.prefixes
        if key in cache:
            cache.move_to_end(key)
        else:
            cache[key] = None
            while len(cache) > self.prefix_cache_size:
                cache.popitem(last=False)
