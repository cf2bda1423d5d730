"""Serving-path error taxonomy — a copy of ``kubeflow_tpu/serving/errors.py``.

Every class subclasses :class:`RuntimeError` on purpose: the pre-existing
contract is "engine trouble surfaces as RuntimeError → the HTTP layer's
503", and callers (GenerativeModel.predict, tests) match on that. The subclasses let the overload plane distinguish *why* a
request died — queue shed vs deadline vs shutdown — without breaking any
``except RuntimeError`` handler that predates them.

Kept dependency-free (no torch, no metrics).
"""

from __future__ import annotations

from typing import Optional


class DeadlineExceeded(RuntimeError):
    """The request's deadline passed before it produced a full result.

    Raised from ``result()`` when the deadline expired while the request
    was still QUEUED (it never occupied a slot — fail fast). A deadline
    expiring MID-DECODE does not raise: the engine frees the slot and the
    request completes with its partial tokens.
    """


class RequestCancelled(RuntimeError):
    """The client abandoned the request (``cancel()`` / disconnect) while
    it was still queued. In-flight cancellations complete with partial
    tokens instead."""


class EngineClosed(RuntimeError):
    """The engine shut down (close(), drain, or a fatal device error)
    with this request still unserved. Distinct from a per-request timeout:
    retrying the same engine is pointless, retry another replica."""


class FleetSaturated(RuntimeError):
    """Every admissible replica is at capacity — shed load.

    ``retry_after_s`` is the router's queue-drain estimate, surfaced by
    the HTTP layer as a ``Retry-After`` header on the 503 so well-behaved
    clients back off for roughly one drain interval instead of hammering.
    """

    def __init__(self, message: str, retry_after_s: Optional[float] = None):
        super().__init__(message)
        self.retry_after_s = retry_after_s
