"""Continuous batching for KV-cache decode — the port of
``kubeflow_tpu/serving/continuous.py``.

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
- a prompt longer than ``prefill_chunk`` (default: the largest prefill
  bucket) prefills in chunks of that size into a private [1, max_seq]
  cache, one chunk per engine iteration between decode dispatches, holding
  its slot (and arena reservation) from the first chunk; one such prompt
  is in flight at a time, and it adopts through the same splice as a wave;
- finished slots (budget reached / EOS / deadline / cancel) free at event
  time and the next queued request takes the row;
- chunk dispatches overlap: up to ``pipeline`` chunks are in flight, their
  token blocks fetched by non-blocking copies into pinned memory, so host
  dispatch of the next chunk overlaps device work on the current one;
- with ``spec_draft`` each dispatch is one speculative round instead of a
  chunk: ``spec_k`` greedy draft steps over a contiguous per-slot draft
  cache, ONE target forward over ``[tok, d_1 .. d_{k-1}]``, and both
  caches' cursors rolled back to the accepted frontier on the device;
- ``role="prefill"`` engines prefill only and hand each request to
  ``handoff_sink`` as a KV wire blob (``serving/kv_wire.py``);
  ``role="decode"`` engines also take such blobs through
  :meth:`ContinuousBatcher.submit_handoff` and scatter them into the arena.

PyTorch runs eagerly, and unlike JAX it mutates: the step writes the cache
in place (JAX donated it), so the prefill templates (the target's and the
draft's) are zeroed for every wave and the one-row caches (the chunked
prefill's, the draft's full-prompt prefill's) for every use (all are
allocated once per engine); an export reads its rows to the host before
anything can zero them; and every host array the device reads — block
tables and wire blocks included — reaches it through a fresh pinned
staging copy, never a view of an array the host mutates later.
"""

from __future__ import annotations

import collections
import logging
import math
import os
import queue
import threading
import time
from dataclasses import dataclass, field
from typing import Any, Callable, Dict, List, Optional, Sequence, Tuple

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
#: KV handoff blob sizes, ~KBs (tiny configs) to ~100s of MB (long prompts)
HANDOFF_BYTES_BUCKETS = (1024.0, 8192.0, 65536.0, 524288.0, 4194304.0,
                         33554432.0, 268435456.0)

#: ceiling on one batched prefill's rows: every admission group is padded
#: to ``min(slots, MAX_GROUP)``; larger waves are chunked
MAX_GROUP = 8

#: drain-queue sentinel (distinct from the ``None`` shutdown sentinel)
_DRAIN = object()

ROLES = ("unified", "prefill", "decode")

LOG = logging.getLogger(__name__)


def _bucket_for(n: int) -> int:
    for b in PREFILL_BUCKETS:
        if n <= b:
            return b
    raise ValueError(f"prompt length {n} exceeds the largest prefill bucket "
                     f"{PREFILL_BUCKETS[-1]}")


def _block_tile(max_seq: int, requested: int = 16) -> int:
    """Arena tile (``block_t``): the largest value not above ``requested``
    that divides both ``max_seq`` (so the gathered [S, max_blocks*block_t]
    view is shape-identical to the contiguous cache — the bit-parity
    contract) and the smallest prefill bucket (so every bucket splice is a
    whole number of blocks)."""
    base = math.gcd(int(max_seq), PREFILL_BUCKETS[0])
    return next(b for b in range(min(int(requested), base), 0, -1)
                if base % b == 0)


def effective_prefill_chunk(requested: Optional[int], max_seq: int,
                            block_t: int = 1) -> int:
    """The chunked-prefill chunk an engine uses: the largest value not above
    ``requested`` that divides ``max_seq`` (so no chunk start clamps in the
    scalar-cursor cache) and is a whole number of KV blocks. None means the
    largest prefill bucket; 0 or less turns chunking off (returns 0).
    ``GenerativeModel`` routes by the same resolution."""
    if requested is None:
        requested = PREFILL_BUCKETS[-1]
    requested = min(int(requested), int(max_seq))
    if requested <= 0:
        return 0
    step = max(int(block_t), 1)
    for c in range(requested, 0, -1):
        if max_seq % c == 0 and c % step == 0:
            return c
    return 0


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
    #: fired exactly once, from whichever thread finished the request, after
    #: ``done`` is set: the fleet's breaker and tenant metering hang here
    on_done: Optional[Callable[["_Request"], None]] = None
    # one span covers submit()→_retire(), crossing the caller thread into
    # the engine worker — hence start_span/end_span
    span: Optional[Span] = None
    submit_at: Optional[float] = None       # perf_counter at enqueue
    last_token_at: Optional[float] = None   # perf_counter at latest token
    #: the served model's multiplexing id, stamped into its KV export
    model_id: str = ""
    #: the KV wire blob once a prefill-role engine has shipped it; a
    #: draining decode engine hands the request back with it set
    kv_blob: Optional[bytes] = None

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

    def _notify(self) -> None:
        """Fire ``on_done`` once; a failing callback cannot reach the worker."""
        cb, self.on_done = self.on_done, None
        if cb is not None:
            try:
                cb(self)
            except Exception:  # the callback's fault, not the request's
                LOG.exception("on_done callback failed")


def _ev(req: _Request, name: str, **attrs: Any) -> None:
    if req.span is not None:
        req.span.add_event(name, **attrs)


def _trace_id(req: _Request) -> Optional[str]:
    return req.span.trace_id if req.span is not None else None


@dataclass(eq=False)
class _ChunkedPrefill:
    """The one long prompt mid-chunked-prefill: it owns ``slot`` and (paged)
    the reservation ``res`` from its first chunk, and is in neither
    ``_active`` nor ``_pending`` until it adopts."""
    req: _Request
    slot: int
    pos: int = 0                       # prompt tokens prefilled so far
    res: Optional[KVReservation] = None


@dataclass(eq=False)
class _Import:
    """One KV-wire import awaiting a decode slot: its blocks arrived
    prefilled (and, int8, quantized); admission reserves arena blocks like
    any other request."""
    req: _Request
    manifest: Dict[str, Any]
    arrays: Dict[str, torch.Tensor]


def _fail(req: _Request, error: BaseException) -> None:
    """Single failure path: error the future AND close the span."""
    req.error = error
    if req.finish_reason is None:
        req.finish_reason = "error"
    if req.span is not None:
        TRACER.end_span(req.span, error=error)
        req.span = None
    req.done.set()
    req._notify()


def _zero(cache: Dict[str, Any]) -> None:
    for layer in cache.values():
        for t in layer["attention"].values():
            t.zero_()


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
    ``kv_kernel=False`` takes the plain PyTorch writes. ``prefill_chunk``:
    prompts longer than it prefill in chunks of that size between decode
    dispatches (None = the largest prefill bucket, which also extends the
    servable prompt range up to ``max_seq`` minus the budget; 0 turns it
    off, and a prompt above the largest bucket then fails at admission).
    ``seed`` seeds the engine's one sampling generator (None = OS entropy).

    ``spec_draft=(draft_cfg, draft_params)`` turns on speculative decoding:
    each dispatch is one round of ``spec_k`` (at least 2) greedy draft steps
    and ONE target forward that verifies them; greedy rows emit exactly the
    plain engine's tokens, sampled rows one token a round drawn from the
    verify logits. The draft shares the target's vocab and covers its
    ``max_seq``; its one-token writes take the same ``kv_kernel`` route.

    ``role``: ``"unified"`` (prefill and decode), ``"prefill"`` (every
    admitted request is prefilled, exported with ``serving.kv_wire`` and
    handed to ``handoff_sink(req, blob)``, which takes ownership) or
    ``"decode"`` (also imports such blobs through :meth:`submit_handoff`).
    The roles need the paged arena. ``model_id`` is stamped into exports
    and checked on import.
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
                 prefill_chunk: Optional[int] = None,
                 spec_draft: Optional[Tuple[GptConfig, Params]] = None,
                 spec_k: int = 4,
                 kv_dtype: str = "bf16",
                 role: str = "unified",
                 model_id: str = "",
                 handoff_sink: Optional[Callable[[_Request, bytes], None]] = None,
                 seed: Optional[int] = None,
                 device: DeviceLike = "cuda"):
        self.kv_dtype = str(kv_dtype)
        if self.kv_dtype not in ("bf16", "int8"):
            raise ValueError(f"kv_dtype {self.kv_dtype!r}: expected bf16|int8")
        if self.kv_dtype == "int8" and not paged:
            raise ValueError("kv_dtype='int8' requires paged=True")
        self.role = str(role)
        if self.role not in ROLES:
            raise ValueError(f"role {self.role!r}: expected unified|prefill|decode")
        if self.role != "unified" and not paged:
            raise ValueError("prefill/decode roles require paged=True (the KV wire "
                             "format is block-shaped)")
        self.model_id = str(model_id)
        self.handoff_sink = handoff_sink
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
        #: chaos hooks: seconds of added latency per engine iteration, and a
        #: one-shot poison that fails the next iteration (the worker then
        #: fails everything it holds and closes the engine)
        self.step_delay_s = 0.0
        self.fail_next_step = False
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
            # an upper bound on each slot's cursor at the dispatch frontier
            # (spec rounds move the real one by a data-dependent amount on
            # the device); it drives granting
            self._ub_cursor = np.zeros((slots,), np.int64)
        else:
            self.kv_block_t = 0
            self._alloc = None
        self.spec_k = 0
        if spec_draft is not None:
            draft_cfg, draft_params = spec_draft
            if draft_cfg.vocab_size != cfg.vocab_size:
                raise ValueError("spec draft must share the target's vocab")
            if draft_cfg.max_seq < cfg.max_seq:
                raise ValueError("spec draft max_seq must cover the target's")
            self.spec_k = max(2, int(spec_k))
            self._draft_cfg = draft_cfg
            self._draft_params = {k: v.to(self.device) for k, v in draft_params.items()}
            self._draft_model = GptLM.bind(draft_cfg, self._draft_params, decode=True,
                                           per_slot=True, kv_kernel=kv_kernel)
            self._draft_prefill_model = GptLM.bind(draft_cfg, self._draft_params,
                                                   decode=True)
        self.model = GptLM.bind(cfg, self.params, decode=True, per_slot=True,
                                kv_kernel=kv_kernel, paged=self.paged,
                                kv_dtype=self.kv_dtype)
        self._prefill_model = GptLM.bind(cfg, self.params, decode=True)
        self.cache = self._fresh_cache()
        self._prefill_cache = self._fresh_prefill_cache(cfg, self._group_pad)
        self.prefill_chunk = effective_prefill_chunk(prefill_chunk, cfg.max_seq,
                                                     self.kv_block_t or 1)
        self._chunked: Optional[_ChunkedPrefill] = None
        # the long prompt's private [1, max_seq] cache, zeroed per prompt
        self._chunk_cache = (self._fresh_prefill_cache(cfg, 1)
                             if self.prefill_chunk else None)
        if self.spec_k:
            # the draft stays contiguous: it is small by construction
            self.draft_cache = self._fresh_cache(self._draft_cfg, paged=False)
            self._draft_prefill_cache = self._fresh_prefill_cache(
                self._draft_cfg, self._group_pad)
            # the draft's full-prompt prefill (a chunked prompt, an import)
            self._draft_one_cache = self._fresh_prefill_cache(self._draft_cfg, 1)
        self.last_tok = torch.zeros((slots,), dtype=torch.int32, device=self.device)
        # per-slot temperature: on the device for the step, on the host to
        # decide whether a dispatch samples at all
        self.temps = torch.zeros((slots,), dtype=torch.float32, device=self.device)
        self._temps_host = np.zeros((slots,), np.float32)
        self._gen = torch.Generator(device=self.device).manual_seed(
            int.from_bytes(os.urandom(4), "little") if seed is None else int(seed))
        # queue items are WAVES (lists of requests enqueued atomically) or
        # KV-wire imports; None is the shutdown sentinel
        self._queue: "queue.Queue[Any]" = queue.Queue()
        self._pending: "collections.deque[_Request]" = collections.deque()
        self._active: Dict[int, _Request] = {}
        self._free = list(range(slots))
        self._lock = threading.Lock()
        self._closed = False
        self._draining = False
        #: requests drain() could not serve, futures still open
        self._handoff: List[_Request] = []
        #: KV-wire imports awaiting a slot (decode role)
        self._imports: "collections.deque[_Import]" = collections.deque()
        self._worker = threading.Thread(target=self._loop, name="continuous-batcher",
                                        daemon=True)
        self._worker.start()

    # -- device state ---------------------------------------------------------
    def _zeros(self, shape, dtype) -> torch.Tensor:
        return torch.zeros(shape, dtype=dtype, device=self.device)

    def _fresh_cache(self, cfg: Optional[GptConfig] = None,
                     paged: Optional[bool] = None) -> Dict[str, Any]:
        """The running per-slot cache: the target's (paged or contiguous,
        as the engine is), or with ``cfg`` and ``paged=False`` the draft's
        contiguous one."""
        cfg = cfg or self.cfg
        paged = self.paged if paged is None else paged
        S = self.slots
        layers = {}
        for i in range(cfg.n_layers):
            att = {"cursors": self._zeros((S,), torch.int32)}
            if paged:
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

    def _fresh_prefill_cache(self, cfg: GptConfig, rows: int) -> Dict[str, Any]:
        """A scalar-cursor [rows, max_seq] cache of ``cfg``'s model: the
        group prefill's (``group_pad`` rows) and the one-row prefills'
        (the chunked prompt's, the draft's full prompt); each is zeroed
        before each use."""
        kv = (rows, cfg.max_seq, cfg.n_heads, cfg.head_dim)
        return {f"block_{i}": {"attention": {
            "k": self._zeros(kv, cfg.dtype), "v": self._zeros(kv, cfg.dtype),
            "cursor": self._zeros((), torch.int32)}}
            for i in range(cfg.n_layers)}

    def _to_device(self, host: Any) -> torch.Tensor:
        """Host array (or a host tensor nothing mutates later, such as a
        wire block) → device through a fresh pinned staging copy (the
        caching host allocator keeps it alive until the copy has run), so
        the host may mutate an array right after this returns."""
        t = host if isinstance(host, torch.Tensor) else torch.from_numpy(
            np.array(host, copy=True))
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

    def _any_sampled(self) -> bool:
        return any(self._temps_host[s] > 0.0 for s in self._active)

    def _decode_chunk(self, tables: Optional[torch.Tensor]) -> torch.Tensor:
        """``chunk`` single-token steps over every slot; [slots, chunk]."""
        sampled = self._any_sampled()
        tok = self.last_tok
        out = []
        for _ in range(self.chunk):
            logits = self.model(tok[:, None], self.cache, block_tables=tables)
            tok = self._sample(logits[:, -1], self.temps, sampled)
            out.append(tok)
        self.last_tok = tok
        METRICS.counter("serving_decode_steps_total").inc(self.chunk)
        return torch.stack(out, dim=1)

    def _spec_round(self, tables: Optional[torch.Tensor]) -> Tuple[torch.Tensor, torch.Tensor]:
        """One speculative round over every slot: ``spec_k`` greedy draft
        steps (writing the draft KV of ``tok, d_1 .. d_{k-1}``), ONE target
        forward over ``[tok, d_1 .. d_{k-1}]``, and both caches' cursors
        rolled back to the accepted frontier. Greedy rows accept ``m = 1 +
        leading draft/target matches`` tokens — exactly plain greedy
        decode's, since each is conditioned on accepted history only, and
        positions below ``C + m`` of both caches hold accepted tokens' KV.
        Sampled rows accept one token, drawn from the verify logits at
        position 0. Returns (toks [S, k], m [S]); every value stays on the
        device."""
        k = self.spec_k
        tok = self.last_tok
        d, drafts = tok, []
        for _ in range(k):
            logits = self._draft_model(d[:, None], self.draft_cache)
            d = torch.argmax(logits[:, -1], dim=-1).to(torch.int32)
            drafts.append(d)
        drafts = torch.stack(drafts, dim=1)                          # [S, k]
        seg = torch.cat([tok[:, None], drafts[:, :k - 1]], dim=1)
        logits = self.model(seg, self.cache, block_tables=tables)   # [S, k, V]
        greedy = torch.argmax(logits, dim=-1).to(torch.int32)
        sampled = self._any_sampled()
        toks = torch.cat([self._sample(logits[:, 0], self.temps, sampled)[:, None],
                          greedy[:, 1:]], dim=1)
        match = (drafts[:, :k - 1] == greedy[:, :k - 1]).to(torch.int32)
        m = 1 + torch.cumprod(match, dim=1).sum(dim=1).to(torch.int32)
        if sampled:
            m = torch.where(self.temps > 0.0, torch.ones_like(m), m)
        back = (k - m).to(torch.int32)
        for cache in (self.cache, self.draft_cache):
            for layer in cache.values():
                layer["attention"]["cursors"] -= back
        self.last_tok = toks.gather(1, (m.long() - 1)[:, None])[:, 0]
        METRICS.counter("serving_spec_rounds_total").inc()
        return toks, m

    def _group_ids(self, prompts: Sequence[np.ndarray]) -> Tuple[np.ndarray, np.ndarray]:
        """A same-bucket group's prompts padded to [group_pad, bucket], and
        each row's true length (1 for padding rows)."""
        n = len(prompts)
        bucket = _bucket_for(max(len(p) for p in prompts))
        if n > self._group_pad:
            raise ValueError(f"admission group of {n} exceeds pad {self._group_pad}")
        ids = np.zeros((self._group_pad, bucket), np.int32)
        true_lens = np.ones((self._group_pad,), np.int64)
        for i, p in enumerate(prompts):
            ids[i, : len(p)] = p
            true_lens[i] = len(p)
        return ids, true_lens

    def _prefill_group(self, prompts: Sequence[np.ndarray],
                       temperatures: Sequence[float]) -> torch.Tensor:
        """ONE batched prefill for a same-bucket admission group into the
        zeroed prefill cache (shared cursor 0), padded to the engine's
        fixed group size. Returns each row's first token [group_pad]."""
        ids, true_lens = self._group_ids(prompts)
        temps = np.zeros((self._group_pad,), np.float32)
        temps[:len(temperatures)] = temperatures
        _zero(self._prefill_cache)
        model = self._prefill_model
        hidden = model(self._to_device(ids), self._prefill_cache, return_hidden=True)
        # each row's first token comes from ITS true last prompt position
        rows = torch.arange(self._group_pad, device=self.device)
        last = hidden[rows, self._to_device(true_lens) - 1]
        logits = last @ model.embedding.weight.float().T
        return self._sample(logits, self._to_device(temps), bool((temps > 0).any()))

    def _draft_prefill(self, cache: Dict[str, Any], ids: np.ndarray) -> None:
        """The draft's prefill of ``ids`` [rows, L] into the zeroed
        scalar-cursor ``cache``; only its KV is read (no LM head)."""
        _zero(cache)
        self._draft_prefill_model(self._to_device(ids), cache, return_hidden=True)

    def _draft_adopt(self, src: Dict[str, Any], slots: List[int],
                     true_lens: List[int]) -> None:
        """Splice rows ``0..n-1`` of the draft prefill cache ``src`` into the
        contiguous draft cache at ``slots``, cursors at the true lengths."""
        n = len(slots)
        slots_t = self._to_device(np.asarray(slots, np.int64))
        lens_t = self._to_device(np.asarray(true_lens, np.int32))
        for name, layer in self.draft_cache.items():
            att, small = layer["attention"], src[name]["attention"]
            att["k"][slots_t] = small["k"][:n]
            att["v"][slots_t] = small["v"][:n]
            att["cursors"][slots_t] = lens_t

    def _draft_full_prompt(self, prompt: np.ndarray, width: int, slot: int) -> None:
        """The draft adopts one prompt through a single forward over it
        padded to ``width`` (a chunked prompt's chunks, an import's
        blocks): the draft is small, so chunking it would only add
        dispatches."""
        ids = np.zeros((1, width), np.int32)
        ids[0, :len(prompt)] = prompt
        self._draft_prefill(self._draft_one_cache, ids)
        self._draft_adopt(self._draft_one_cache, [slot], [len(prompt)])

    def _adopt(self, src: Dict[str, Any], n: int, slots: List[int], true_lens: List[int],
               first: torch.Tensor, temperatures: List[float],
               block_ids: Optional[np.ndarray]) -> None:
        """Splice rows ``0..n-1`` of the prefill cache ``src`` (a wave's, or
        the chunked prefill's) into the running cache at ``slots`` and set
        their cursors to the true prompt lengths (padding above them stays
        masked until decode overwrites it). Paged: rows go block by block
        into the arena rows named by ``block_ids`` ([n, nb]; trailing trash
        entries absorb the padding), quantized first (``quantize_kv``, for
        either source) when the arena is int8."""
        slots_t = self._to_device(np.asarray(slots, np.int64))
        lens_t = self._to_device(np.asarray(true_lens, np.int32))
        if block_ids is not None:
            bt = self.kv_block_t
            nb = block_ids.shape[1]
            ids = self._to_device(block_ids.reshape(-1).astype(np.int64))
        for name, layer in self.cache.items():
            att = layer["attention"]
            small = src[name]["attention"]
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
               priority: str = "interactive",
               on_done: Optional[Callable[[_Request], None]] = None) -> _Request:
        """``traceparent`` (W3C header value) parents the request's span to
        the caller's trace. ``deadline`` is an ABSOLUTE ``time.monotonic()``
        instant: a request whose deadline passes while queued fails fast
        with :class:`DeadlineExceeded`; one that expires mid-decode frees
        its slot within ~one decode chunk and completes with the partial
        tokens. An already-expired deadline fails the returned future (and
        does not fire ``on_done``: it says nothing of this replica) rather
        than raising, so a fleet cannot mistake it for a dead replica. A
        prompt above the largest prefill bucket goes to chunked prefill;
        with ``prefill_chunk=0`` it fails its own future at admission
        (ValueError). ``on_done(req)`` fires once when the request finishes,
        however it finishes; a request that :meth:`drain` hands back has
        not finished."""
        if priority not in PRIORITIES:
            raise ValueError(f"priority {priority!r}; expected one of {PRIORITIES}")
        prompt = np.asarray(prompt_ids, np.int32).reshape(-1)
        if len(prompt) + max_new_tokens > self.cfg.max_seq:
            raise ValueError("prompt + budget exceeds max_seq")
        if self.paged:
            need = self._alloc.blocks_for(len(prompt) + max_new_tokens)
            if need > self._alloc.n_blocks:
                raise ValueError(
                    f"prompt + budget needs {need} KV blocks; the arena has "
                    f"{self._alloc.n_blocks} (raise kv_blocks)")
        req = _Request(prompt, max_new_tokens, eos_id=eos_id,
                       temperature=float(temperature), deadline=deadline,
                       priority=priority, on_done=on_done, model_id=self.model_id)
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
            req.on_done = None
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
        """Take a request prefilled elsewhere: ``blob`` is a prefill-role
        engine's KV wire export. The frame, every crc32 and the manifest's
        fit (kv_dtype, block_t, model_id, prompt_len, blocks) are checked
        here, on the caller's thread, so a bad blob raises where the caller
        can still send the request elsewhere. The same request object
        continues: its future, span and deadline carry over."""
        if self.role == "prefill":
            raise ValueError("prefill-role engines cannot import KV")
        if not self.paged:
            raise ValueError("KV import requires the paged arena layout")
        from .kv_wire import unpack_kv

        manifest, arrays = unpack_kv(blob)
        if manifest.get("kv_dtype") != self.kv_dtype:
            raise ValueError(f"wire kv_dtype {manifest.get('kv_dtype')!r} != engine "
                             f"{self.kv_dtype!r}")
        if int(manifest.get("block_t", 0)) != self.kv_block_t:
            raise ValueError(f"wire block_t {manifest.get('block_t')} != engine "
                             f"{self.kv_block_t}")
        if manifest.get("model_id", "") != self.model_id:
            raise ValueError(f"wire model {manifest.get('model_id')!r} != replica model "
                             f"{self.model_id!r}")
        if int(manifest.get("prompt_len", -1)) != len(req.prompt):
            raise ValueError("wire prompt_len disagrees with the request")
        need = self._alloc.blocks_for(len(req.prompt) + req.max_new_tokens)
        if need > self._alloc.n_blocks:
            raise ValueError(f"prompt + budget needs {need} KV blocks; the arena has "
                             f"{self._alloc.n_blocks} (raise kv_blocks)")
        req.kv_blob = blob
        with self._lock:
            if self._closed:
                raise EngineClosed("batcher closed")
            self._queue.put(_Import(req=req, manifest=manifest, arrays=arrays))
        return req

    def cancel_requests(self, n: int = 1) -> int:
        """Abandon up to ``n`` in-flight, then queued, requests (a client
        disconnect, or evicting stuck work). Returns how many were marked;
        the worker reaps each within ~one decode chunk. The chunked prefill
        in flight counts as in flight."""
        for _ in range(3):
            try:
                cp = self._chunked
                reqs = list(self._active.values()) + ([cp.req] if cp else []) \
                    + list(self._pending)
                break
            except RuntimeError:
                continue  # the worker resized a container mid-copy; retry
        else:
            return 0
        marked = 0
        for req in reqs:
            if marked >= n:
                break
            if req.cancel():
                marked += 1
        return marked

    def prewarm(self, prompt_len: int, timeout: float = 600.0) -> None:
        """Bring the engine's paths up outside any latency window: for each
        admission-group size ``1.._group_pad`` a wave of
        dummy requests of ``prompt_len`` tokens goes in as ONE queue item,
        so the worker admits it as one group. Waves run in turn; the last
        wave's budget is ``chunk + 1`` tokens, so it runs a decode chunk.
        On the card nothing compiles: this is where cuBLAS's handles and
        the caching allocator's pools come up. ``timeout`` is each dummy
        request's deadline, so a wedged run raises
        :class:`DeadlineExceeded`."""
        deadline = time.monotonic() + timeout
        sizes = range(1, self._group_pad + 1)
        for idx, n in enumerate(sizes):
            budget = self.chunk + 1 if idx == len(sizes) - 1 else 1
            wave = [_Request(np.zeros((prompt_len,), np.int32), budget, deadline=deadline)
                    for _ in range(n)]
            with self._lock:
                if self._closed:
                    raise EngineClosed("batcher closed")
                self._queue.put(wave)
            for req in wave:
                # bounded by the request's own deadline plus a grace for the
                # worker to reap and fail it
                req.result(timeout=max(0.0, deadline - time.monotonic()) + 5.0)

    def close(self) -> None:
        with self._lock:
            self._closed = True
            self._queue.put(None)
        self._worker.join(timeout=30)

    def drain(self, timeout: float = 600.0) -> List[_Request]:
        """Graceful shutdown: stop admission, let in-flight slots run to
        completion, then return the unserved requests with their futures
        still open — the queued ones, and the KV imports not yet admitted
        (their ``kv_blob`` set, to import elsewhere). Idempotent."""
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
        back: List[_Request] = []  # re-queued (chunked lane busy, arena full)
        for req in reqs:
            if self.prefill_chunk and len(req.prompt) > self.prefill_chunk:
                # long prompt: chunked prefill, one in flight at a time (it
                # holds a slot from its first chunk)
                if self._chunked is not None or not self._free \
                        or not self._start_chunked(req):
                    back.append(req)
                continue
            try:
                bucket = _bucket_for(len(req.prompt))
            except ValueError as e:  # fails alone and takes no slot
                _fail(req, e)
                continue
            by_bucket.setdefault(bucket, []).append(req)
        groups = [chunk[i:i + self._group_pad]
                  for chunk in by_bucket.values()
                  for i in range(0, len(chunk), self._group_pad)]
        for group in groups:
            if self.role == "prefill":
                # a prefill specialist: ONE batched prefill, then each row's
                # KV and first token go over the wire — no slot, no arena
                # reservation, no decode
                try:
                    t0 = time.perf_counter()
                    first = self._prefill_group([r.prompt for r in group],
                                                [r.temperature for r in group])
                except Exception as e:
                    for req in group:
                        _fail(req, e)
                    continue
                METRICS.histogram(
                    "serving_prefill_seconds", buckets=PREFILL_BUCKETS_S
                ).observe(time.perf_counter() - t0, trace_id=_trace_id(group[0]))
                self._export_group(group, first)
                continue
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
                lens = [len(r.prompt) for r in group]
                self._adopt(self._prefill_cache, n, slots, lens, first,
                            [r.temperature for r in group], block_ids)
                if self.spec_k:
                    # the draft adopts the same prompts before any round
                    # includes these rows
                    ids, _ = self._group_ids([r.prompt for r in group])
                    self._draft_prefill(self._draft_prefill_cache, ids)
                    self._draft_adopt(self._draft_prefill_cache, slots, lens)
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
            # or for the chunked-prefill lane
            for r in reversed(back):
                self._pending.appendleft(r)
            self._set_queue_gauge()
        self._set_occupancy()
        return events

    # -- KV handoff: prefill-role export ---------------------------------------
    def _export_group(self, group: List[_Request], first: torch.Tensor) -> None:
        """Ship each row of a prefill group: its first token and its
        prefill-cache rows go to the host now (a synchronous read), before
        the next wave or long prompt can zero the template."""
        first_host = first[:len(group)].cpu().numpy()
        for i, req in enumerate(group):
            rows = {nm: {"k": l["attention"]["k"][i], "v": l["attention"]["v"][i]}
                    for nm, l in self._prefill_cache.items()}
            self._ship(req, rows, int(first_host[i]))

    def _ship(self, req: _Request, row_cache: Dict[str, Dict[str, torch.Tensor]],
              first_token: int) -> None:
        """Export ONE prefilled request (its [>= prompt, h, d] cache rows
        per layer, on the device) to the KV wire and hand it to the sink;
        ``export_kv`` quantizes (int8) on the device, as the adopt does,
        and reads the blocks to the host. The sink call is synchronous:
        when it returns, ownership has moved. A failure, or no sink at all,
        fails this request alone."""
        from .kv_wire import export_kv

        sink = self.handoff_sink
        if sink is None:
            _fail(req, RuntimeError("prefill engine has no handoff_sink — a prefill-role "
                                    "replica cannot serve decode itself"))
            return
        try:
            t0 = time.perf_counter()
            blob = export_kv(row_cache, prompt_len=len(req.prompt), block_t=self.kv_block_t,
                             kv_dtype=self.kv_dtype, first_token=first_token,
                             model_id=self.model_id)
            req.kv_blob = blob
            sink(req, blob)
        except Exception as e:
            _fail(req, e)
            return
        dt = time.perf_counter() - t0
        METRICS.counter("serving_kv_handoff_total").inc()
        METRICS.histogram("serving_kv_handoff_bytes",
                          buckets=HANDOFF_BYTES_BUCKETS).observe(float(len(blob)))
        METRICS.histogram("serving_kv_handoff_seconds", buckets=PREFILL_BUCKETS_S
                          ).observe(dt, trace_id=_trace_id(req))
        _ev(req, "kv_handoff", bytes=len(blob))

    # -- chunked prefill ------------------------------------------------------
    def _start_chunked(self, req: _Request) -> bool:
        """Claim a slot (and, paged, the worst-case block reservation) for
        one long prompt and install it as THE chunked prefill; its chunks
        run one per engine iteration from :meth:`_advance_chunked`. False
        when the arena cannot reserve yet (the caller requeues it); a
        request that can never fit fails here and counts as handled."""
        res = None
        # a prefill specialist never decodes: the importing engine reserves
        if self.paged and self.role != "prefill":
            try:
                res = self._alloc.reserve(self._alloc.blocks_for(
                    len(req.prompt) + req.max_new_tokens))
            except FleetSaturated:
                return False
            except ValueError as e:
                _fail(req, e)
                return True
        _zero(self._chunk_cache)
        slot = self._free.pop()
        self._chunked = _ChunkedPrefill(req=req, slot=slot, res=res)
        _ev(req, "chunked_prefill_start", slot=slot,
            chunks=-(-len(req.prompt) // self.prefill_chunk))
        return True

    def _abort_chunked(self, cp: _ChunkedPrefill) -> None:
        """Release a mid-prefill request's slot and (paged) blocks; the
        caller fails the request. Retire ordering: the table row goes to
        trash before the blocks return."""
        if self.paged:
            self._tables[cp.slot, :] = self._alloc.trash
            self._slot_res.pop(cp.slot, None)
            self._ub_cursor[cp.slot] = 0
            if cp.res is not None:
                self._alloc.release(cp.res)
        self._free.append(cp.slot)
        self._chunked = None

    def _advance_chunked(self) -> List[Tuple[str, Any, Any, float]]:
        """Run ONE prefill chunk of the long prompt; after the last, adopt
        it into the running cache and activate its slot. Cancel and
        deadline are tested before each chunk. Returns the 'first' event
        when the adoption happens."""
        cp = self._chunked
        req = cp.req
        if req.done.is_set():  # failed elsewhere: just clean up
            self._abort_chunked(cp)
            return []
        if req.cancel_requested:
            req.finish_reason = "cancelled"
            METRICS.counter("serving_cancelled_total").inc()
            _ev(req, "cancelled", stage="prefill")
            self._abort_chunked(cp)
            _fail(req, RequestCancelled("cancelled during chunked prefill"))
            return []
        if req.expired():
            req.finish_reason = "deadline"
            METRICS.counter("serving_deadline_expired_total", stage="prefill").inc()
            _ev(req, "deadline_expired", stage="prefill")
            self._abort_chunked(cp)
            _fail(req, DeadlineExceeded("deadline expired during chunked prefill"))
            return []
        n, c, start = len(req.prompt), self.prefill_chunk, cp.pos
        ids = np.zeros((1, c), np.int32)
        seg = req.prompt[start:start + c]
        ids[0, :len(seg)] = seg
        # the last chunk's padding writes KV at positions >= n; the adopted
        # cursor n masks it until decode overwrites it
        hidden = self._prefill_model(self._to_device(ids), self._chunk_cache,
                                     return_hidden=True)
        cp.pos = start + c
        METRICS.counter("serving_prefill_chunks_total").inc()
        _ev(req, "prefill_chunk", start=start)
        if cp.pos < n:
            return []
        # last chunk: the first token from the prompt's true last position,
        # through the f32 head as the group prefill takes it
        last = hidden[0, (n - 1) - start][None]
        logits = last @ self._prefill_model.embedding.weight.float().T
        temps = np.asarray([req.temperature], np.float32)
        first = self._sample(logits, self._to_device(temps), req.temperature > 0.0)
        if self.role == "prefill":
            # export instead of adopting: the importing engine owns it now
            rows = {nm: {"k": l["attention"]["k"][0], "v": l["attention"]["v"][0]}
                    for nm, l in self._chunk_cache.items()}
            tok = int(first[0])
            self._abort_chunked(cp)
            self._ship(req, rows, tok)
            return []
        slot = cp.slot
        block_ids = None
        if self.paged:
            nb = cp.pos // self.kv_block_t  # whole blocks: block_t divides the chunk
            block_ids = np.full((1, nb), self._alloc.trash, np.int32)
            self._alloc.grant(cp.res, self._alloc.blocks_for(n))
            block_ids[0, :len(cp.res.granted)] = cp.res.granted
            self._tables[slot, :len(cp.res.granted)] = cp.res.granted
            self._slot_res[slot] = cp.res
            self._ub_cursor[slot] = n
        self._adopt(self._chunk_cache, 1, [slot], [n], first, [req.temperature], block_ids)
        if self.spec_k:
            self._draft_full_prompt(req.prompt, cp.pos, slot)
        fetch = _Fetch(first)
        now = time.perf_counter()
        self._active[slot] = req
        self._chunked = None
        if req.submit_at is not None:
            METRICS.histogram("serving_queue_wait_seconds", buckets=QUEUE_WAIT_BUCKETS,
                              ).observe(now - req.submit_at, trace_id=_trace_id(req))
        _ev(req, "admitted", slot=slot)
        _ev(req, "prefill_done")
        self._set_occupancy()
        return [("first", fetch, [(req, slot)], now)]

    # -- KV handoff: decode-role import -----------------------------------------
    def _admit_imports(self) -> List[Tuple[str, Any, Any, float]]:
        """Admit queued KV-wire imports into free slots: reserve arena blocks
        (an exhausted arena leaves the import queued, in its place), grant
        the prompt's blocks, scatter the wire blocks into the arena, install
        the cursor, ``last_tok`` and temperature, and (spec) re-prefill the
        draft locally — the wire carries no draft KV. The 'first' event
        carries the prefill engine's first token, so TTFT runs from the
        original submit. A failed import frees its slot and blocks and
        fails its own request."""
        events: List[Tuple[str, Any, Any, float]] = []
        quant = self.kv_dtype == "int8"
        while self._imports and self._free:
            imp = self._imports[0]
            req = imp.req
            if req.done.is_set():
                self._imports.popleft()
                continue
            if req.cancel_requested:
                self._imports.popleft()
                req.finish_reason = "cancelled"
                METRICS.counter("serving_cancelled_total").inc()
                _ev(req, "cancelled", stage="import")
                _fail(req, RequestCancelled("cancelled before KV import"))
                continue
            if req.expired():
                self._imports.popleft()
                req.finish_reason = "deadline"
                METRICS.counter("serving_deadline_expired_total", stage="queued").inc()
                _ev(req, "deadline_expired", stage="import")
                _fail(req, DeadlineExceeded("deadline expired before KV import"))
                continue
            n = len(req.prompt)
            try:
                res = self._alloc.reserve(self._alloc.blocks_for(n + req.max_new_tokens))
            except FleetSaturated:
                break  # no blocks yet; the import keeps its place in line
            except ValueError as e:
                self._imports.popleft()
                _fail(req, e)
                continue
            self._imports.popleft()
            slot = self._free.pop()
            try:
                nb = self._alloc.blocks_for(n)
                self._alloc.grant(res, nb)
                block_ids = np.asarray(res.granted, np.int32)
                if any(a.shape[0] != nb for a in imp.arrays.values()):
                    raise ValueError(f"wire carries a block count != {nb} for prompt_len {n}")
                self._tables[slot, :nb] = block_ids
                self._slot_res[slot] = res
                self._ub_cursor[slot] = n
                ids = self._to_device(block_ids.astype(np.int64))
                kinds = ("k", "v", "k_scale", "v_scale") if quant else ("k", "v")
                for name, layer in self.cache.items():
                    att = layer["attention"]
                    for kind in kinds:
                        dst = att[f"{kind}_arena"] if kind in ("k", "v") else att[kind]
                        dst[ids] = self._to_device(imp.arrays[f"{name}/{kind}"]).to(dst.dtype)
                    att["cursors"][slot] = n
                self.last_tok[slot] = int(imp.manifest["first_token"])
                self.temps[slot] = req.temperature
                self._temps_host[slot] = req.temperature
                if self.spec_k:
                    self._draft_full_prompt(req.prompt, nb * self.kv_block_t, slot)
            except Exception as e:
                self._free.append(slot)
                self._tables[slot, :] = self._alloc.trash
                self._slot_res.pop(slot, None)
                self._ub_cursor[slot] = 0
                self._alloc.release(res)
                _fail(req, e)
                continue
            now = time.perf_counter()
            self._active[slot] = req
            if req.submit_at is not None:
                METRICS.histogram("serving_queue_wait_seconds", buckets=QUEUE_WAIT_BUCKETS,
                                  ).observe(now - req.submit_at, trace_id=_trace_id(req))
            METRICS.counter("serving_kv_import_total").inc()
            _ev(req, "admitted", slot=slot)
            _ev(req, "kv_import", blocks=int(nb))
            first = torch.tensor([int(imp.manifest["first_token"])], dtype=torch.int32)
            events.append(("first", _Fetch(first), [(req, slot)], now))
        self._set_occupancy()
        return events

    def _grant_active(self, tokens: int) -> None:
        """Advance every active slot's cursor upper bound by the tokens the
        next dispatch may write (a chunk, or a spec round's ``spec_k``) and
        grant the blocks that frontier needs — BEFORE the dispatch
        snapshots the table. The bound, never a cursor read back, drives
        granting; positions past the reservation stay on trash."""
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
        req._notify()
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
        """Fail everything in flight (the chunked prefill too), pending,
        awaiting import and still queued — all with the SAME cause."""
        if self._chunked is not None:
            # in neither _active nor _pending: forgetting it would hang its
            # caller
            cp = self._chunked
            self._abort_chunked(cp)
            _fail(cp.req, EngineClosed(cause))
        for req in self._active.values():
            _fail(req, EngineClosed(cause))
        self._active.clear()
        while self._pending:
            _fail(self._pending.popleft(), EngineClosed(cause))
        while self._imports:
            _fail(self._imports.popleft().req, EngineClosed(cause))
        self._set_queue_gauge()
        while True:
            try:
                rest = self._queue.get_nowait()
            except queue.Empty:
                return
            if isinstance(rest, _Import):
                _fail(rest.req, EngineClosed(cause))
            elif rest is not None and rest is not _DRAIN:
                for req in rest:
                    _fail(req, EngineClosed(cause))

    def _process_event(self, event: Tuple[str, Any, Any, float]) -> None:
        """Consume one pipelined event in dispatch order. ``first``: an
        admission group's first tokens. ``chunk``: a token block, retired
        against the DISPATCH-TIME snapshot of the active slots. ``spec``:
        one speculative round's [slots, spec_k] tokens and each row's
        accepted width m; only the first m of a row are real."""
        kind, fetch, meta, dispatched_at = event
        widths = None
        if kind == "spec":
            toks_fetch, m_fetch = fetch
            block, widths = toks_fetch.numpy(), m_fetch.numpy()
        else:
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
        for slot, req in meta.items():
            width = int(widths[slot]) if widths is not None else block.shape[1]
            if widths is not None and not req.done.is_set():
                # spec_k - 1 verifiable drafts a round; m - 1 of them were
                # accepted (the +1 is the target's own token)
                METRICS.counter("serving_spec_tokens_drafted_total").inc(self.spec_k - 1)
                if width > 1:
                    METRICS.counter("serving_spec_tokens_accepted_total").inc(width - 1)
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
            return sum(1 for kind, _, _, _ in events if kind in ("chunk", "spec"))

        while True:
            # drain arrivals into the pending deque; block only when fully
            # idle. Coalescing lets a burst of submits admit as ONE prefill.
            try:
                timeout = (None if not (self._active or self._pending
                                        or events or self._draining
                                        or self._chunked or self._imports)
                           else 0.0)
                while True:
                    item = self._queue.get(timeout=timeout) if timeout is None \
                        else self._queue.get_nowait()
                    if item is None:
                        self._shutdown("batcher closed mid-flight")
                        return
                    if item is _DRAIN:
                        self._draining = True
                    elif isinstance(item, _Import):
                        self._imports.append(item)
                    else:
                        self._enqueue_pendings(item)
                    timeout = 0.0
            except queue.Empty:
                pass
            self._set_queue_gauge()
            try:
                if self.fail_next_step:
                    # chaos: poison this iteration; the handler below fails
                    # everything and closes the engine, as a device death would
                    self.fail_next_step = False
                    raise RuntimeError("chaos: replica crashed mid-decode")
                if self.step_delay_s > 0:
                    # chaos: a slow replica, so deadlines expire and a
                    # fleet's breaker sees it
                    time.sleep(min(self.step_delay_s, 5.0))
                # reap BEFORE admission: an expired queued request must never
                # take a slot, and an expired in-flight one frees its slot
                self._reap_pending()
                self._reap_active()
                dispatched = False
                if self._imports and self._free and not self._draining:
                    # imports admit before fresh prompts: their prefill is
                    # already spent
                    events.extend(self._admit_imports())
                    dispatched = True
                if self._free and self._pending and not self._draining:
                    wave = self._next_wave(len(self._free))
                    self._set_queue_gauge()
                    events.extend(self._admit_wave(wave))
                    dispatched = True
                if self._chunked is not None:
                    # ONE prefill chunk per iteration, between decode
                    # dispatches, draining included: the short requests'
                    # tokens do not wait on the whole long prompt
                    events.extend(self._advance_chunked())
                    dispatched = True
                if self._active:
                    # one CHUNK of decode steps for every slot (inactive rows
                    # compute too; their tokens are discarded against the
                    # snapshot)
                    self._grant_active(self.spec_k or self.chunk)
                    tables = self._to_device(self._tables) if self.paged else None
                    if self.spec_k:
                        toks, m = self._spec_round(tables)
                        events.append(("spec", (_Fetch(toks), _Fetch(m)),
                                       dict(self._active), time.perf_counter()))
                    else:
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
                if (self._draining and not self._active and not events
                        and self._chunked is None):
                    # drain complete: park the unserved pendings for the
                    # caller, and the unadmitted imports (``kv_blob`` set)
                    self._handoff.extend(self._pending)
                    self._pending.clear()
                    self._handoff.extend(imp.req for imp in self._imports
                                         if not imp.req.done.is_set())
                    self._imports.clear()
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
