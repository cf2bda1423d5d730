"""Continuous batching for KV-cache decode — the port of
``kubeflow_tpu/serving/continuous.py`` in its unified role.

Slot-based admission over one per-slot KV cache:

- ONE decode step over a fixed ``slots``-row batch; every step produces one
  token per slot, ``chunk`` steps per dispatch;
- the KV cache keeps a cursor PER ROW (``GptLM(per_slot=True)``), either
  contiguous ``[slots, max_seq]`` or a shared paged block arena (bf16 or
  int8) with a host-side block table; single-token writes go through the
  CUDA KV kernels when ``kv_kernel`` is on;
- new requests admit in WAVES: each same-prompt-bucket group (at most
  ``min(slots, MAX_GROUP)`` rows) runs ONE batched prefill and ONE adopt
  splice into the running cache;
- finished slots (budget reached / EOS / deadline / cancel) free at event
  time and the next queued request takes the row;
- chunk dispatches overlap: up to ``pipeline`` chunks are in flight, their
  token blocks fetched by non-blocking copies into pinned memory, so host
  dispatch of the next chunk overlaps device work on the current one.

PyTorch runs eagerly, and unlike JAX it mutates: the step writes the cache
in place (JAX donated it), so the prefill template is zeroed for every wave
(JAX reused one zero template because prefill did not donate it), and every
host array the device reads — block tables included — reaches it through a
fresh pinned staging copy, never a view of an array the host mutates later.

Not in this slice (see ROADMAP.md): speculative decoding, chunked prefill
of prompts above the largest prefill bucket, prefill/decode roles and the
KV wire. Those raise at construction or submit.
"""

from __future__ import annotations

import collections
import math
import os
import queue
import threading
import time
from dataclasses import dataclass, field
from typing import Any, Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from ..device import DeviceLike, resolve_device
from ..models.gpt import GptConfig, GptLM, Params, sample_tokens
from ..ops.kv_cache import quantize_kv
from ..runtime.metrics import METRICS
from ..runtime.tracing import TRACER, Span
from .errors import (DeadlineExceeded, EngineClosed, FleetSaturated,
                     RequestCancelled)
from .paged import KVBlockAllocator, KVReservation

#: admission priority classes; batch is shed first under saturation
PRIORITIES = ("interactive", "batch")

#: prompt-length buckets — one prefill shape each
PREFILL_BUCKETS = (16, 32, 64, 128, 256)

#: SLO histogram ladders (docs/OBSERVABILITY.md)
TTFT_BUCKETS = (0.005, 0.01, 0.025, 0.05, 0.1, 0.25, 0.5, 1.0, 2.5, 5.0,
                10.0, 30.0, 60.0)
ITL_BUCKETS = (0.0005, 0.001, 0.0025, 0.005, 0.01, 0.025, 0.05, 0.1, 0.25,
               0.5, 1.0)
QUEUE_WAIT_BUCKETS = (0.001, 0.005, 0.01, 0.05, 0.1, 0.5, 1.0, 5.0, 15.0,
                      60.0)
PREFILL_BUCKETS_S = (0.001, 0.005, 0.01, 0.05, 0.1, 0.25, 0.5, 1.0, 2.5,
                     10.0)
DECODE_CHUNK_BUCKETS = (0.001, 0.0025, 0.005, 0.01, 0.025, 0.05, 0.1, 0.25,
                        0.5, 1.0, 2.5)

#: ceiling on one batched prefill's rows: every admission group is padded
#: to ``min(slots, MAX_GROUP)``; larger waves are chunked
MAX_GROUP = 8

#: drain-queue sentinel (distinct from the ``None`` shutdown sentinel)
_DRAIN = object()

_LATER = "ROADMAP.md queue A, item 4 (serving beyond the first slice)"


def _bucket_for(n: int) -> int:
    for b in PREFILL_BUCKETS:
        if n <= b:
            return b
    raise ValueError(f"prompt length {n} exceeds the largest prefill bucket "
                     f"{PREFILL_BUCKETS[-1]} (chunked prefill: {_LATER})")


def _block_tile(max_seq: int, requested: int = 16) -> int:
    """Arena tile (``block_t``): the largest value not above ``requested``
    that divides both ``max_seq`` (so the gathered [S, max_blocks*block_t]
    view is shape-identical to the contiguous cache — the bit-parity
    contract) and the smallest prefill bucket (so every bucket splice is a
    whole number of blocks)."""
    base = math.gcd(int(max_seq), PREFILL_BUCKETS[0])
    return next(b for b in range(min(int(requested), base), 0, -1)
                if base % b == 0)


@dataclass(eq=False)  # identity equality: field eq would compare ndarrays
class _Request:
    prompt: np.ndarray  # [prompt_len] int32
    max_new_tokens: int
    done: threading.Event = field(default_factory=threading.Event)
    tokens: List[int] = field(default_factory=list)
    error: Optional[BaseException] = None
    eos_id: Optional[int] = None
    temperature: float = 0.0  # 0 = greedy
    done_at: Optional[float] = None  # perf_counter at retirement
    deadline: Optional[float] = None  # absolute time.monotonic(); None = none
    priority: str = "interactive"     # "interactive" | "batch"
    cancel_requested: bool = False    # client abandoned; worker reaps the slot
    #: "ok" (budget/EOS), "deadline", "cancelled" or "error"
    finish_reason: Optional[str] = None
    # one span covers submit()→_retire(), crossing the caller thread into
    # the engine worker — hence start_span/end_span
    span: Optional[Span] = None
    submit_at: Optional[float] = None       # perf_counter at enqueue
    last_token_at: Optional[float] = None   # perf_counter at latest token

    def result(self, timeout: Optional[float] = None) -> List[int]:
        if not self.done.wait(timeout):
            raise TimeoutError("request not finished")
        if self.error is not None:
            raise self.error
        return self.tokens

    def expired(self) -> bool:
        return self.deadline is not None and time.monotonic() >= self.deadline

    def cancel(self) -> bool:
        """Abandon the request. A queued request fails fast with
        :class:`RequestCancelled`; an in-flight one frees its slot within
        ~one decode chunk and completes with the partial tokens. False if
        already finished."""
        if self.done.is_set():
            return False
        self.cancel_requested = True
        return True


def _ev(req: _Request, name: str, **attrs: Any) -> None:
    if req.span is not None:
        req.span.add_event(name, **attrs)


def _trace_id(req: _Request) -> Optional[str]:
    return req.span.trace_id if req.span is not None else None


def _fail(req: _Request, error: BaseException) -> None:
    """Single failure path: error the future AND close the span."""
    req.error = error
    if req.finish_reason is None:
        req.finish_reason = "error"
    if req.span is not None:
        TRACER.end_span(req.span, error=error)
        req.span = None
    req.done.set()


class _Fetch:
    """A token block on its way to the host: on the card, a non-blocking
    copy into pinned memory plus an event that marks its completion."""

    def __init__(self, dev: torch.Tensor):
        self.event: Optional[torch.cuda.Event] = None
        if dev.device.type == "cuda":
            self.host = torch.empty(dev.shape, dtype=dev.dtype, pin_memory=True)
            self.host.copy_(dev, non_blocking=True)
            self.event = torch.cuda.Event()
            self.event.record()
        else:
            self.host = dev

    def numpy(self) -> np.ndarray:
        if self.event is not None:
            self.event.synchronize()
        return self.host.numpy()


class ContinuousBatcher:
    """Slot-based decode engine over one per-slot KV cache.

    Usage:
        eng = ContinuousBatcher(cfg, params, slots=8, device="cuda")
        fut = eng.submit([1, 2, 3], max_new_tokens=32)
        tokens = fut.result(timeout=60)
        eng.close()

    ``params`` is the state dict of a ``GptLM`` (``init_params`` or
    ``params_from_flax``); it is moved to ``device`` once and shared by the
    step and prefill modules. ``chunk`` = decode steps per dispatch;
    ``pipeline`` = chunk dispatches kept in flight. ``paged`` selects the
    shared block arena (default) over the contiguous per-slot cache,
    ``kv_blocks`` sizes the arena (None = ``slots * max_seq / block_t``),
    ``kv_dtype`` is ``"bf16"`` or ``"int8"`` (paged only). ``kv_kernel``
    (default on) routes single-token KV writes through the CUDA kernels;
    ``kv_kernel=False`` takes the plain PyTorch writes. ``seed`` seeds
    the engine's one sampling generator (None = OS entropy).
    """

    def __init__(self, cfg: GptConfig, params: Params, slots: int = 8,
                 chunk: int = 16, pipeline: int = 3,
                 kv_kernel: bool = True,
                 engine_id: str = "0",
                 max_pending: int = 0,
                 interactive_reserve: float = 0.25,
                 paged: bool = True,
                 kv_blocks: Optional[int] = None,
                 kv_block_t: int = 16,
                 spec_draft: Optional[Tuple[GptConfig, Any]] = None,
                 kv_dtype: str = "bf16",
                 role: str = "unified",
                 seed: Optional[int] = None,
                 device: DeviceLike = "cuda"):
        if spec_draft is not None:
            raise NotImplementedError(f"speculative decoding: {_LATER}")
        if role != "unified":
            raise NotImplementedError(
                f"role {role!r}: prefill/decode roles and the KV wire: {_LATER}")
        self.kv_dtype = str(kv_dtype)
        if self.kv_dtype not in ("bf16", "int8"):
            raise ValueError(f"kv_dtype {self.kv_dtype!r}: expected bf16|int8")
        if self.kv_dtype == "int8" and not paged:
            raise ValueError("kv_dtype='int8' requires paged=True")
        self.device = resolve_device(device)
        self.cfg = cfg
        self.params = {k: v.to(self.device) for k, v in params.items()}
        self.slots = slots
        self.engine_id = str(engine_id)
        self.chunk = max(1, int(chunk))
        self.pipeline = max(1, int(pipeline))
        # admission-queue cap (0 = unbounded): batch requests shed at
        # (1 - interactive_reserve) * max_pending, interactive at the cap
        self.max_pending = max(0, int(max_pending))
        self.interactive_reserve = min(max(float(interactive_reserve), 0.0), 1.0)
        self._group_pad = min(slots, MAX_GROUP)
        self.paged = bool(paged)
        if self.paged:
            self.kv_block_t = _block_tile(cfg.max_seq, kv_block_t)
            self._max_blocks = cfg.max_seq // self.kv_block_t
            n_blocks = int(kv_blocks) if kv_blocks else slots * self._max_blocks
            self._alloc: Optional[KVBlockAllocator] = KVBlockAllocator(
                n_blocks, self.kv_block_t, engine_id=self.engine_id)
            # ONE host-side block table shared by every layer; entries
            # default to the trash block
            self._tables = np.full((slots, self._max_blocks),
                                   self._alloc.trash, np.int32)
            self._slot_res: Dict[int, KVReservation] = {}
            # each slot's cursor at the dispatch frontier (drives granting)
            self._ub_cursor = np.zeros((slots,), np.int64)
        else:
            self.kv_block_t = 0
            self._alloc = None
        self.model = GptLM.bind(cfg, self.params, decode=True, per_slot=True,
                                kv_kernel=kv_kernel, paged=self.paged,
                                kv_dtype=self.kv_dtype)
        self._prefill_model = GptLM.bind(cfg, self.params, decode=True)
        self.cache = self._fresh_cache()
        self._prefill_cache = self._fresh_prefill_cache()
        self.last_tok = torch.zeros((slots,), dtype=torch.int32, device=self.device)
        # per-slot temperature: on the device for the step, on the host to
        # decide whether a dispatch samples at all
        self.temps = torch.zeros((slots,), dtype=torch.float32, device=self.device)
        self._temps_host = np.zeros((slots,), np.float32)
        self._gen = torch.Generator(device=self.device).manual_seed(
            int.from_bytes(os.urandom(4), "little") if seed is None else int(seed))
        # queue items are WAVES (lists of requests enqueued atomically);
        # None is the shutdown sentinel
        self._queue: "queue.Queue[Any]" = queue.Queue()
        self._pending: "collections.deque[_Request]" = collections.deque()
        self._active: Dict[int, _Request] = {}
        self._free = list(range(slots))
        self._lock = threading.Lock()
        self._closed = False
        self._draining = False
        #: requests drain() could not serve, futures still open
        self._handoff: List[_Request] = []
        self._worker = threading.Thread(target=self._loop, name="continuous-batcher",
                                        daemon=True)
        self._worker.start()

    # -- device state ---------------------------------------------------------
    def _zeros(self, shape, dtype) -> torch.Tensor:
        return torch.zeros(shape, dtype=dtype, device=self.device)

    def _fresh_cache(self) -> Dict[str, Any]:
        cfg, S = self.cfg, self.slots
        layers = {}
        for i in range(cfg.n_layers):
            att = {"cursors": self._zeros((S,), torch.int32)}
            if self.paged:
                arena = (self._alloc.n_blocks + 1, self.kv_block_t,
                         cfg.n_heads, cfg.head_dim)
                quant = self.kv_dtype == "int8"
                att["k_arena"] = self._zeros(arena, torch.int8 if quant else cfg.dtype)
                att["v_arena"] = self._zeros(arena, torch.int8 if quant else cfg.dtype)
                if quant:
                    att["k_scale"] = self._zeros(arena[:3] + (1,), torch.float32)
                    att["v_scale"] = self._zeros(arena[:3] + (1,), torch.float32)
            else:
                kv = (S, cfg.max_seq, cfg.n_heads, cfg.head_dim)
                att["k"] = self._zeros(kv, cfg.dtype)
                att["v"] = self._zeros(kv, cfg.dtype)
            layers[f"block_{i}"] = {"attention": att}
        return layers

    def _fresh_prefill_cache(self) -> Dict[str, Any]:
        """The scalar-cursor [group_pad, max_seq] cache every group prefill
        writes into; zeroed before each use."""
        cfg = self.cfg
        kv = (self._group_pad, cfg.max_seq, cfg.n_heads, cfg.head_dim)
        return {f"block_{i}": {"attention": {
            "k": self._zeros(kv, cfg.dtype), "v": self._zeros(kv, cfg.dtype),
            "cursor": self._zeros((), torch.int32)}}
            for i in range(cfg.n_layers)}

    def _to_device(self, host: np.ndarray) -> torch.Tensor:
        """Host array → device through a fresh pinned staging copy (the
        caching host allocator keeps it alive until the copy has run), so
        the host may mutate ``host`` right after this returns."""
        t = torch.from_numpy(np.array(host, copy=True))
        if self.device.type != "cuda":
            return t
        return t.pin_memory().to(self.device, non_blocking=True)

    def _sample(self, logits: torch.Tensor, temps: torch.Tensor,
                sampled: bool) -> torch.Tensor:
        """Per-row greedy or (rows with temperature > 0) sampled tokens."""
        greedy = sample_tokens(logits, 0.0, None)
        if not sampled:
            return greedy
        noise = torch.empty_like(logits).exponential_(generator=self._gen)
        drawn = torch.argmax(logits / temps.clamp_min(1e-6)[:, None]
                             - torch.log(noise), dim=-1).to(torch.int32)
        return torch.where(temps > 0.0, drawn, greedy)

    def _decode_chunk(self, tables: Optional[torch.Tensor]) -> torch.Tensor:
        """``chunk`` single-token steps over every slot; [slots, chunk]."""
        sampled = any(self._temps_host[s] > 0.0 for s in self._active)
        tok = self.last_tok
        out = []
        for _ in range(self.chunk):
            logits = self.model(tok[:, None], self.cache, block_tables=tables)
            tok = self._sample(logits[:, -1], self.temps, sampled)
            out.append(tok)
        self.last_tok = tok
        return torch.stack(out, dim=1)

    def _prefill_group(self, prompts: Sequence[np.ndarray],
                       temperatures: Sequence[float]) -> torch.Tensor:
        """ONE batched prefill for a same-bucket admission group into the
        zeroed prefill cache (shared cursor 0), padded to the engine's
        fixed group size. Returns each row's first token [group_pad]."""
        n = len(prompts)
        bucket = _bucket_for(max(len(p) for p in prompts))
        n_pad = self._group_pad
        if n > n_pad:
            raise ValueError(f"admission group of {n} exceeds pad {n_pad}")
        ids = np.zeros((n_pad, bucket), np.int32)
        true_lens = np.ones((n_pad,), np.int64)
        temps = np.zeros((n_pad,), np.float32)
        for i, p in enumerate(prompts):
            ids[i, : len(p)] = p
            true_lens[i] = len(p)
            temps[i] = temperatures[i]
        for layer in self._prefill_cache.values():
            for t in layer["attention"].values():
                t.zero_()
        model = self._prefill_model
        hidden = model(self._to_device(ids), self._prefill_cache, return_hidden=True)
        # each row's first token comes from ITS true last prompt position
        rows = torch.arange(n_pad, device=self.device)
        last = hidden[rows, self._to_device(true_lens) - 1]
        logits = last @ model.embedding.weight.float().T
        return self._sample(logits, self._to_device(temps), bool((temps > 0).any()))

    def _adopt(self, n: int, slots: List[int], true_lens: List[int],
               first: torch.Tensor, temperatures: List[float],
               block_ids: Optional[np.ndarray]) -> None:
        """Splice prefill rows ``0..n-1`` into the running cache at
        ``slots`` and set their cursors to the true prompt lengths (bucket
        padding above them stays masked until decode overwrites it). Paged:
        rows go block by block into the arena rows named by ``block_ids``
        ([n, nb]; trailing trash entries absorb bucket padding), quantized
        first when the arena is int8."""
        slots_t = self._to_device(np.asarray(slots, np.int64))
        lens_t = self._to_device(np.asarray(true_lens, np.int32))
        if block_ids is not None:
            bt = self.kv_block_t
            nb = block_ids.shape[1]
            ids = self._to_device(block_ids.reshape(-1).astype(np.int64))
        for name, layer in self.cache.items():
            att = layer["attention"]
            small = self._prefill_cache[name]["attention"]
            if block_ids is None:
                att["k"][slots_t] = small["k"][:n]
                att["v"][slots_t] = small["v"][:n]
            else:
                for kind in ("k", "v"):
                    seg = small[kind][:n, :nb * bt].reshape(
                        n * nb, bt, *small[kind].shape[2:])
                    if self.kv_dtype == "int8":
                        q, s = quantize_kv(seg)
                        att[f"{kind}_arena"][ids] = q
                        att[f"{kind}_scale"][ids] = s
                    else:
                        att[f"{kind}_arena"][ids] = seg.to(att[f"{kind}_arena"].dtype)
            att["cursors"][slots_t] = lens_t
        self.last_tok[slots_t] = first[:n]
        self.temps[slots_t] = self._to_device(np.asarray(temperatures, np.float32))
        self._temps_host[slots] = temperatures

    # -- public API ----------------------------------------------------------
    def submit(self, prompt_ids, max_new_tokens: int,
               eos_id: Optional[int] = None,
               temperature: float = 0.0,
               traceparent: Optional[str] = None,
               deadline: Optional[float] = None,
               priority: str = "interactive") -> _Request:
        """``traceparent`` (W3C header value) parents the request's span to
        the caller's trace. ``deadline`` is an ABSOLUTE ``time.monotonic()``
        instant: a request whose deadline passes while queued fails fast
        with :class:`DeadlineExceeded`; one that expires mid-decode frees
        its slot within ~one decode chunk and completes with the partial
        tokens. Prompts above the largest prefill bucket raise ValueError
        (chunked prefill is not in this slice)."""
        if priority not in PRIORITIES:
            raise ValueError(f"priority {priority!r}; expected one of {PRIORITIES}")
        prompt = np.asarray(prompt_ids, np.int32).reshape(-1)
        if len(prompt) + max_new_tokens > self.cfg.max_seq:
            raise ValueError("prompt + budget exceeds max_seq")
        _bucket_for(len(prompt))
        if self.paged:
            need = self._alloc.blocks_for(len(prompt) + max_new_tokens)
            if need > self._alloc.n_blocks:
                raise ValueError(
                    f"prompt + budget needs {need} KV blocks; the arena has "
                    f"{self._alloc.n_blocks} (raise kv_blocks)")
        req = _Request(prompt, max_new_tokens, eos_id=eos_id,
                       temperature=float(temperature),
                       deadline=deadline, priority=priority)
        req.span = TRACER.start_span(
            "serving.request", traceparent=traceparent,
            **{"prompt_tokens": int(len(prompt)),
               "max_new_tokens": int(max_new_tokens),
               "priority": priority, "replica": self.engine_id})
        req.submit_at = time.perf_counter()
        _ev(req, "enqueued")
        METRICS.counter("serving_tokens_in_total").inc(len(prompt))
        if req.expired():  # dead on arrival: shed before it costs anything
            METRICS.counter("serving_deadline_expired_total", stage="queued").inc()
            _ev(req, "deadline_expired", stage="queued")
            req.finish_reason = "deadline"
            _fail(req, DeadlineExceeded("deadline already expired at submit"))
            return req
        # closed-check and enqueue under one lock: a put racing close()
        # could otherwise land AFTER the shutdown sentinel
        with self._lock:
            if self._closed:
                _fail(req, EngineClosed("batcher closed"))
                raise EngineClosed("batcher closed")
            self._queue.put([req])
        return req

    def submit_handoff(self, req: _Request, blob: bytes) -> _Request:
        raise NotImplementedError(f"KV-wire import: {_LATER}")

    def close(self) -> None:
        with self._lock:
            self._closed = True
            self._queue.put(None)
        self._worker.join(timeout=30)

    def drain(self, timeout: float = 600.0) -> List[_Request]:
        """Graceful shutdown: stop admission, let in-flight slots run to
        completion, then return the unserved requests with their futures
        still open. Idempotent."""
        with self._lock:
            already = self._closed
            self._closed = True
            if not already:
                self._queue.put(_DRAIN)
        self._worker.join(timeout=timeout)
        return list(self._handoff)

    # -- engine loop ---------------------------------------------------------
    def _admit_wave(self, reqs: List[_Request]) -> List[Tuple[str, Any, Any, float]]:
        """Admit up to ``len(self._free)`` requests: one batched prefill +
        one adopt per same-prompt-bucket group. The first tokens stay on
        the device and are fetched through the returned ``first`` events."""
        events: List[Tuple[str, Any, Any, float]] = []
        by_bucket: Dict[int, List[_Request]] = {}
        back: List[_Request] = []  # re-queued (arena full)
        for req in reqs:
            by_bucket.setdefault(_bucket_for(len(req.prompt)), []).append(req)
        groups = [chunk[i:i + self._group_pad]
                  for chunk in by_bucket.values()
                  for i in range(0, len(chunk), self._group_pad)]
        for group in groups:
            reserved: List[KVReservation] = []
            if self.paged:
                # reserve worst-case blocks BEFORE spending prefill compute;
                # exhaustion is back-pressure, not an error
                admit: List[_Request] = []
                for req in group:
                    try:
                        res = self._alloc.reserve(self._alloc.blocks_for(
                            len(req.prompt) + req.max_new_tokens))
                    except FleetSaturated:
                        back.append(req)
                        continue
                    except ValueError as e:
                        _fail(req, e)
                        continue
                    admit.append(req)
                    reserved.append(res)
                group = admit
                if not group:
                    continue
            n = len(group)
            slots: List[int] = []
            try:
                t0 = time.perf_counter()
                first = self._prefill_group([r.prompt for r in group],
                                            [r.temperature for r in group])
                METRICS.histogram(
                    "serving_prefill_seconds", buckets=PREFILL_BUCKETS_S
                ).observe(time.perf_counter() - t0, trace_id=_trace_id(group[0]))
                slots = [self._free.pop() for _ in range(n)]
                block_ids = None
                if self.paged:
                    # grant each row the blocks its PROMPT needs (decode
                    # grants the rest as cursors advance) and point its
                    # table at them
                    nb = _bucket_for(max(len(r.prompt) for r in group)) // self.kv_block_t
                    block_ids = np.full((n, nb), self._alloc.trash, np.int32)
                    for i, (req, slot, res) in enumerate(zip(group, slots, reserved)):
                        self._alloc.grant(res, self._alloc.blocks_for(len(req.prompt)))
                        block_ids[i, :len(res.granted)] = res.granted
                        self._tables[slot, :len(res.granted)] = res.granted
                        self._slot_res[slot] = res
                        self._ub_cursor[slot] = len(req.prompt)
                self._adopt(n, slots, [len(r.prompt) for r in group], first,
                            [r.temperature for r in group], block_ids)
            except Exception as e:  # the group fails alone
                # restore the slots and blocks, fail the group, keep serving
                self._free.extend(slots)
                for slot in slots:
                    if self.paged:
                        self._tables[slot, :] = self._alloc.trash
                        self._slot_res.pop(slot, None)
                        self._ub_cursor[slot] = 0
                for res in reserved:
                    self._alloc.release(res)
                for req in group:
                    _fail(req, e)
                continue
            fetch = _Fetch(first[:n])
            # activate NOW: the next chunk dispatch must include these rows
            now = time.perf_counter()
            for req, slot in zip(group, slots):
                self._active[slot] = req
                if req.submit_at is not None:
                    METRICS.histogram(
                        "serving_queue_wait_seconds", buckets=QUEUE_WAIT_BUCKETS,
                    ).observe(now - req.submit_at, trace_id=_trace_id(req))
                _ev(req, "admitted", slot=slot)
                _ev(req, "prefill_done")
            events.append(("first", fetch, list(zip(group, slots)), now))
        if back:
            # requeue at the FRONT in arrival order: they only wait for blocks
            for r in reversed(back):
                self._pending.appendleft(r)
            self._set_queue_gauge()
        self._set_occupancy()
        return events

    def _grant_active(self, tokens: int) -> None:
        """Advance every active slot's cursor frontier by the tokens the next
        dispatch writes and grant the blocks it needs — BEFORE the dispatch
        snapshots the table."""
        if not self.paged:
            return
        max_seq = self.cfg.max_seq
        for slot in self._active:
            res = self._slot_res.get(slot)
            if res is None:
                continue
            ub = min(int(self._ub_cursor[slot]) + tokens, max_seq)
            self._ub_cursor[slot] = ub
            base = len(res.granted)
            for off, blk in enumerate(
                    self._alloc.grant(res, self._alloc.blocks_for(ub))):
                self._tables[slot, base + off] = blk

    def _set_occupancy(self) -> None:
        active = len(self._active)
        METRICS.gauge("serving_continuous_active_slots",
                      replica=self.engine_id).set(active)
        METRICS.gauge("serving_slot_occupancy", replica=self.engine_id).set(
            active / self.slots if self.slots else 0.0)

    def _retire(self, slot: int) -> None:
        req = self._active.pop(slot)
        self._free.append(slot)
        if self.paged:
            # retire-ordering invariant: the table row goes to TRASH before
            # the blocks return to the free list, so later dispatches can
            # only write a re-granted block through its new owner's table
            self._tables[slot, :] = self._alloc.trash
            res = self._slot_res.pop(slot, None)
            if res is not None:
                self._alloc.release(res)
            self._ub_cursor[slot] = 0
        req.done_at = time.perf_counter()
        if req.finish_reason is None:
            req.finish_reason = "ok"
        if req.submit_at is not None:
            METRICS.histogram("serving_request_seconds").observe(
                req.done_at - req.submit_at, trace_id=_trace_id(req))
        if req.span is not None:
            _ev(req, "retired", slot=slot)
            req.span.set("generated_tokens", len(req.tokens))
            req.span.set("finish_reason", req.finish_reason)
            TRACER.end_span(req.span)
            req.span = None
        req.done.set()
        METRICS.counter("serving_continuous_requests_total").inc()
        self._set_occupancy()

    def _set_queue_gauge(self) -> None:
        METRICS.gauge("serving_queue_depth",
                      replica=self.engine_id).set(len(self._pending))

    def _reap_pending(self) -> None:
        """Shed queued requests that will never need a slot: expired
        deadlines and abandoned clients."""
        if not self._pending:
            return
        kept: "collections.deque[_Request]" = collections.deque()
        for req in self._pending:
            if req.cancel_requested:
                METRICS.counter("serving_cancelled_total").inc()
                _ev(req, "cancelled", stage="queued")
                req.finish_reason = "cancelled"
                _fail(req, RequestCancelled("cancelled while queued"))
            elif req.expired():
                METRICS.counter("serving_deadline_expired_total",
                                stage="queued").inc()
                _ev(req, "deadline_expired", stage="queued")
                req.finish_reason = "deadline"
                _fail(req, DeadlineExceeded(
                    "deadline expired while queued (never admitted)"))
            else:
                kept.append(req)
        self._pending = kept
        self._set_queue_gauge()

    def _reap_active(self) -> None:
        """Free the slot of any in-flight request whose deadline expired or
        whose future was abandoned; it completes with its partial tokens."""
        for slot, req in list(self._active.items()):
            if req.cancel_requested:
                req.finish_reason = "cancelled"
                METRICS.counter("serving_cancelled_total").inc()
                _ev(req, "cancelled", stage="decoding",
                    partial_tokens=len(req.tokens))
                self._retire(slot)
            elif req.expired():
                req.finish_reason = "deadline"
                METRICS.counter("serving_deadline_expired_total",
                                stage="decoding").inc()
                _ev(req, "deadline_expired", stage="decoding",
                    partial_tokens=len(req.tokens))
                self._retire(slot)

    def _enqueue_pendings(self, reqs: List[_Request]) -> None:
        for req in reqs:
            if self.max_pending:
                depth = len(self._pending)
                batch_cap = max(1, int(self.max_pending
                                       * (1.0 - self.interactive_reserve)))
                cap = batch_cap if req.priority == "batch" else self.max_pending
                if depth >= cap:
                    METRICS.counter("serving_shed_total", priority=req.priority).inc()
                    _ev(req, "shed", priority=req.priority, depth=depth)
                    _fail(req, FleetSaturated(
                        f"engine queue full ({depth} >= {cap} "
                        f"for priority={req.priority})"))
                    continue
            self._pending.append(req)

    def _next_wave(self, n: int) -> List[_Request]:
        """Interactive-first admission: fill up to ``n`` free slots from the
        interactive pendings before any batch request is considered."""
        if len(self._pending) <= n:
            wave = list(self._pending)
            self._pending.clear()
            return wave
        wave = [r for r in self._pending if r.priority != "batch"][:n]
        if len(wave) < n:
            wave.extend([r for r in self._pending
                         if r.priority == "batch"][: n - len(wave)])
        for r in wave:
            self._pending.remove(r)
        return wave

    def _shutdown(self, cause: str) -> None:
        """Fail everything in flight, pending, and still queued — all with
        the SAME cause."""
        for req in self._active.values():
            _fail(req, EngineClosed(cause))
        self._active.clear()
        while self._pending:
            _fail(self._pending.popleft(), EngineClosed(cause))
        self._set_queue_gauge()
        while True:
            try:
                rest = self._queue.get_nowait()
            except queue.Empty:
                return
            if rest is not None and rest is not _DRAIN:
                for req in rest:
                    _fail(req, EngineClosed(cause))

    def _process_event(self, event: Tuple[str, Any, Any, float]) -> None:
        """Consume one pipelined event in dispatch order. ``first``: an
        admission group's first tokens. ``chunk``: a token block, retired
        against the DISPATCH-TIME snapshot of the active slots."""
        kind, fetch, meta, dispatched_at = event
        block = fetch.numpy()
        now = time.perf_counter()
        if kind == "first":
            for (req, slot), tok in zip(meta, block):
                if req.done.is_set():
                    # reaped between admission and this event
                    if req.finish_reason in ("deadline", "cancelled"):
                        METRICS.counter("serving_wasted_decode_tokens_total").inc()
                    continue
                req.tokens.append(int(tok))
                req.last_token_at = now
                METRICS.counter("serving_tokens_out_total").inc()
                if req.submit_at is not None:
                    METRICS.histogram(
                        "serving_ttft_seconds", buckets=TTFT_BUCKETS
                    ).observe(now - req.submit_at, trace_id=_trace_id(req))
                _ev(req, "first_token")
                hit_eos = req.eos_id is not None and req.tokens[-1] == req.eos_id
                if req.max_new_tokens <= 1 or hit_eos:
                    self._retire(slot)
            return
        # dispatch→fetch-complete latency of one pipelined decode chunk
        METRICS.histogram(
            "serving_decode_chunk_seconds", buckets=DECODE_CHUNK_BUCKETS
        ).observe(now - dispatched_at)
        width = block.shape[1]
        for slot, req in meta.items():
            if req.done.is_set():
                # retired in an earlier event: this row's block was
                # computed for nobody
                METRICS.counter("serving_discarded_tail_tokens_total").inc(width)
                if req.finish_reason in ("deadline", "cancelled"):
                    METRICS.counter("serving_wasted_decode_tokens_total").inc(width)
                continue
            appended = 0
            for j in range(width):
                tok = int(block[slot, j])
                req.tokens.append(tok)
                appended += 1
                hit_eos = req.eos_id is not None and tok == req.eos_id
                if len(req.tokens) >= req.max_new_tokens or hit_eos:
                    self._note_tokens(req, appended, now)
                    self._retire(slot)
                    METRICS.counter(
                        "serving_discarded_tail_tokens_total").inc(width - j - 1)
                    appended = 0
                    break
            if appended:
                self._note_tokens(req, appended, now)

    def _note_tokens(self, req: _Request, n: int, now: float) -> None:
        METRICS.counter("serving_tokens_out_total").inc(n)
        if req.last_token_at is not None:
            METRICS.histogram(
                "serving_inter_token_seconds", buckets=ITL_BUCKETS
            ).observe((now - req.last_token_at) / n, count=n,
                      trace_id=_trace_id(req))
        req.last_token_at = now

    def _loop(self) -> None:
        if self.device.type == "cuda":
            torch.cuda.set_device(self.device)
        with torch.no_grad():
            self._run()

    def _run(self) -> None:
        events: "collections.deque[Tuple[str, Any, Any, float]]" = collections.deque()

        def chunk_depth() -> int:
            return sum(1 for kind, _, _, _ in events if kind == "chunk")

        while True:
            # drain arrivals into the pending deque; block only when fully
            # idle. Coalescing lets a burst of submits admit as ONE prefill.
            try:
                timeout = (None if not (self._active or self._pending
                                        or events or self._draining)
                           else 0.0)
                while True:
                    item = self._queue.get(timeout=timeout) if timeout is None \
                        else self._queue.get_nowait()
                    if item is None:
                        self._shutdown("batcher closed mid-flight")
                        return
                    if item is _DRAIN:
                        self._draining = True
                    else:
                        self._enqueue_pendings(item)
                    timeout = 0.0
            except queue.Empty:
                pass
            self._set_queue_gauge()
            try:
                # reap BEFORE admission: an expired queued request must never
                # take a slot, and an expired in-flight one frees its slot
                self._reap_pending()
                self._reap_active()
                dispatched = False
                if self._free and self._pending and not self._draining:
                    wave = self._next_wave(len(self._free))
                    self._set_queue_gauge()
                    events.extend(self._admit_wave(wave))
                    dispatched = True
                if self._active:
                    # one CHUNK of decode steps for every slot (inactive rows
                    # compute too; their tokens are discarded against the
                    # snapshot)
                    self._grant_active(self.chunk)
                    tables = self._to_device(self._tables) if self.paged else None
                    toks = self._decode_chunk(tables)
                    events.append(("chunk", _Fetch(toks), dict(self._active),
                                   time.perf_counter()))
                    dispatched = True
                # keep the dispatch frontier at most ``pipeline`` chunks
                # ahead; when nothing new was dispatched, drain one event
                while chunk_depth() > self.pipeline:
                    self._process_event(events.popleft())
                if not dispatched and events:
                    self._process_event(events.popleft())
                if self._draining and not self._active and not events:
                    # drain complete: park the unserved pendings for the caller
                    self._handoff.extend(self._pending)
                    self._pending.clear()
                    self._set_queue_gauge()
                    self._set_occupancy()
                    return
            except Exception as e:  # the worker's boundary
                # a device failure must not wedge the engine silently: fail
                # everything in flight, pending, and queued; refuse new work
                with self._lock:
                    self._closed = True
                self._shutdown(f"engine step failed: {type(e).__name__}: {e}")
                return
