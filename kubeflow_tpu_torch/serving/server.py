"""Model server of the port: the TF-Serving-compatible predict surface.

API shape (the same as ``kubeflow_tpu/serving/server.py``):
    POST /v1/models/<name>:predict   {"instances": [...]}
    ->                               {"predictions": [...]}
    GET  /v1/models/<name>           status/metadata
    GET  /healthz
    GET  /metrics, /debug/*          the observability routes (runtime/obs.py)

``ServedModel`` pads a batch to the next ``BATCH_BUCKETS`` size and runs
``apply_fn`` once; ``ModelServer(batching=True)`` coalesces concurrent
requests per model into one such forward (``serving/batching.py``).
``GenerativeModel`` serves autoregressive generation through the
continuous-batching engine, or through an ``EngineFleet`` of several
(``replicas``, ``max_replicas``, ``pools``, ``mux_models``);
``gpt_served_model`` builds GPT-small (or the tiny config) and
``bert_served_model`` BERT-base (or tiny) with seeded random weights.
``python -m kubeflow_tpu_torch.serving.server`` runs one of them on the
card.
"""

from __future__ import annotations

import math
import threading
import time
from dataclasses import dataclass, field
from typing import Any, Callable, Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from ..device import DeviceLike, resolve_device
from ..runtime.metrics import METRICS
from ..runtime.obs import mount_observability
from ..runtime.tracing import TRACER, format_traceparent
from ..web.http import App, HttpError, Request
from .batching import BatcherClosed, DynamicBatcher
from .errors import DeadlineExceeded, FleetSaturated

#: batch sizes the static ``generate()`` path pads a request to (the JAX
#: server's ``BATCH_BUCKETS``); a larger batch is refused with 413
BATCH_BUCKETS = (1, 2, 4, 8, 16, 32, 64, 128)

#: per-request budget when the client sends neither the
#: ``X-Request-Deadline-Ms`` header nor a ``timeout_ms`` body field
DEFAULT_DEADLINE_MS = 600_000.0

#: extra wait past the deadline for the engine to reap an expired slot and
#: hand back the partial tokens
DEADLINE_GRACE_S = 5.0


def request_deadline_opts(req: Request, body: Any) -> Tuple[float, str]:
    """(absolute monotonic deadline, priority) for one predict request: the
    ``X-Request-Deadline-Ms`` header wins over the body's ``timeout_ms``;
    priority comes from the body's ``priority`` or ``X-Request-Priority``."""
    raw: Any = req.header("x-request-deadline-ms") or None
    if raw is None and isinstance(body, dict):
        raw = body.get("timeout_ms")
    try:
        ms = float(raw) if raw is not None else DEFAULT_DEADLINE_MS
    except (TypeError, ValueError):
        raise HttpError(400, f"bad deadline {raw!r}: expected milliseconds") from None
    priority = ""
    if isinstance(body, dict):
        priority = str(body.get("priority") or "")
    priority = priority or req.header("x-request-priority") or "interactive"
    if priority not in ("interactive", "batch"):
        raise HttpError(400, f"priority {priority!r}: expected 'interactive' or 'batch'")
    return time.monotonic() + ms / 1000.0, priority


def retry_after_headers(e: FleetSaturated) -> Dict[str, str]:
    hint = e.retry_after_s if e.retry_after_s else 1.0
    return {"Retry-After": str(max(1, int(math.ceil(hint))))}


#: JAX's default 32-bit mode: what ``jnp.asarray`` makes of a 64-bit
#: ``preprocess`` output
_X32 = {np.dtype(np.float64): np.dtype(np.float32), np.dtype(np.int64): np.dtype(np.int32)}


@dataclass
class ServedModel:
    """One deployable model: ``apply(params, batch) -> out`` run eagerly on
    ``device`` under ``torch.no_grad()``. ``predict`` casts the instances to
    ``input_dtype`` (or runs ``preprocess`` on them), pads the batch to the
    next ``BATCH_BUCKETS`` size with copies of row 0, and returns the first
    n rows; above the largest bucket it answers 413."""

    name: str
    apply_fn: Optional[Callable[[Any, torch.Tensor], torch.Tensor]]
    params: Any
    input_dtype: torch.dtype = torch.float32
    version: str = "1"
    #: raw JSON instances -> np.ndarray batch
    preprocess: Optional[Callable[[Sequence[Any]], np.ndarray]] = None
    device: DeviceLike = "cuda"

    def __post_init__(self):
        self.device = resolve_device(self.device)

    def predict(self, instances: Sequence[Any]) -> List[Any]:
        if not instances:
            return []
        if self.preprocess is not None:
            batch = np.asarray(self.preprocess(instances))
            batch = torch.as_tensor(batch.astype(_X32.get(batch.dtype, batch.dtype)))
        else:
            batch = torch.as_tensor(np.asarray(instances)).to(self.input_dtype)
        n = batch.shape[0]
        bucket = next((b for b in BATCH_BUCKETS if b >= n), None)
        if bucket is None:
            raise HttpError(413, f"batch of {n} exceeds max {BATCH_BUCKETS[-1]}")
        if bucket != n:
            batch = torch.cat([batch, batch[:1].expand(bucket - n, *batch.shape[1:])])
        with torch.no_grad():
            out = self.apply_fn(self.params, batch.to(self.device))
        return out[:n].cpu().tolist()

    def close(self) -> None:
        pass


class ModelServer:
    """Hosts ServedModels over the predict API; servable with serve().
    ``/metrics`` and ``/debug/*`` are mounted on the same app.

    ``batching=True`` coalesces concurrent requests per model into one
    padded forward (``serving/batching.py``), at most ``max_batch`` rows
    after waiting at most ``max_wait_ms``."""

    def __init__(self, batching: bool = False, max_batch: int = BATCH_BUCKETS[-1],
                 max_wait_ms: float = 5.0):
        if max_batch > BATCH_BUCKETS[-1]:
            # a combined batch above the largest bucket would 413 on every
            # co-batched request
            raise ValueError(f"max_batch {max_batch} exceeds largest bucket {BATCH_BUCKETS[-1]}")
        self.models: Dict[str, ServedModel] = {}
        self.app = App("model-server")
        self._batching = batching
        self._max_batch = max_batch
        self._max_wait_ms = max_wait_ms
        self._batchers: Dict[str, DynamicBatcher] = {}
        self._register_routes()
        # the SLO histograms live in this process, so the scrape must too
        mount_observability(self.app)

    def add(self, model: ServedModel) -> "ModelServer":
        self.models[model.name] = model
        if self._batching:
            old = self._batchers.pop(model.name, None)
            if old is not None:
                old.close()  # model reload: stop the old worker
            self._batchers[model.name] = DynamicBatcher(
                model.predict, max_batch=self._max_batch,
                max_wait_ms=self._max_wait_ms, name=model.name)
        return self

    def _predict(self, model: ServedModel, instances, deadline: Optional[float] = None,
                 priority: str = "interactive", model_id: Optional[str] = None) -> List[Any]:
        batcher = self._batchers.get(model.name)
        if batcher is not None:
            try:
                return batcher.predict(instances, deadline=deadline)
            except BatcherClosed:
                # a reload closed the batcher this request fetched: serve it
                # unbatched
                pass
        if isinstance(model, GenerativeModel):
            return model.predict(instances, deadline=deadline, priority=priority,
                                 model=model_id)
        return model.predict(instances)

    def close(self) -> None:
        for b in self._batchers.values():
            b.close()
        for model in self.models.values():
            model.close()

    def _model(self, name: str) -> ServedModel:
        model = self.models.get(name)
        if model is None:
            raise HttpError(404, f"model {name!r} not loaded")
        return model

    def _register_routes(self) -> None:
        app = self.app

        @app.route("/healthz")
        def healthz(req: Request):
            return {"status": "ok", "models": sorted(self.models)}

        @app.route("/v1/models/<name>")
        def model_status(req: Request):
            model = self._model(req.params["name"])
            return {"model_version_status": [
                {"version": model.version, "state": "AVAILABLE",
                 "status": {"error_code": "OK"}}]}

        @app.route("/v1/models/<name>:predict", methods=("POST",))
        def predict(req: Request):
            model = self._model(req.params["name"])
            body = req.json or {}
            instances = body.get("instances")
            if instances is None:
                raise HttpError(400, "body must carry 'instances'")
            deadline, priority = request_deadline_opts(req, body)
            # a multiplexing servable routes on the body's "model" id
            model_id = body.get("model") if isinstance(body, dict) else None
            t0 = time.perf_counter()
            try:
                predictions = self._predict(model, instances, deadline=deadline,
                                            priority=priority, model_id=model_id)
            except HttpError:
                raise
            except DeadlineExceeded as e:
                METRICS.counter("serving_predict_total", model=model.name,
                                result="error").inc()
                raise HttpError(504, f"deadline exceeded: {e}") from None
            except Exception as e:  # the handler's boundary: report, keep serving
                METRICS.counter("serving_predict_total", model=model.name,
                                result="error").inc()
                raise HttpError(400, f"inference failed: {e}") from None
            METRICS.counter("serving_predict_total", model=model.name,
                            result="success").inc()
            METRICS.histogram("serving_predict_seconds", model=model.name).observe(
                time.perf_counter() - t0)
            return {"predictions": predictions}

    def serve(self, port: int = 0):
        return self.app.serve(port)


@dataclass
class GenerativeModel(ServedModel):
    """Serves autoregressive generation through the predict surface:
    instances = equal-length token-id prompts, predictions = full generated
    sequences (prompt + ``max_new_tokens``).

    ``continuous=True`` (the default) routes requests through one
    continuous-batching engine built on first use; a prompt above the
    largest prefill bucket goes there too when the engine's chunked prefill
    is on (``prefill_chunk`` None = the largest bucket, 256), and takes the
    static ``generate()`` path when it is off (``prefill_chunk=0``), so the
    servable prompt range stays ``cfg.max_seq`` either way.
    ``continuous=False`` serves every request through the static path, the
    batch padded to a ``BATCH_BUCKETS`` size. The routing is the JAX
    server's (``kubeflow_tpu/serving/server.py:381-392``).

    ``replicas > 1``, ``max_replicas``, ``pools`` or ``mux_models`` serve
    through an ``EngineFleet`` (``serving/fleet.py``) with the same engine
    options, as JAX's ``_wants_fleet`` decides; a multiplexing servable
    takes the model id from the request body's ``"model"``."""

    cfg: Any = None
    max_new_tokens: int = 16
    temperature: float = 0.0
    continuous: bool = True
    slots: int = 8
    #: > 1 serves through an EngineFleet of that many replicas
    replicas: int = 1
    #: the fleet's autoscaling headroom; None pins it at ``replicas``
    max_replicas: Optional[int] = None
    paged: bool = True
    #: allocatable arena blocks (None = contiguous-capacity parity)
    kv_blocks: Optional[int] = None
    #: requested arena tile (shrunk to divide max_seq and the buckets)
    kv_block_t: int = 16
    #: chunked-prefill budget (None = the largest prefill bucket; 0 turns it
    #: off, and over-bucket prompts take the static generate() path)
    prefill_chunk: Optional[int] = None
    #: (draft_cfg, draft_params) turns on speculative decoding
    spec_draft: Optional[Any] = None
    spec_k: int = 4
    kv_dtype: str = "bf16"
    #: role pools of a disaggregated fleet, e.g. {"prefill": 1, "decode": 2}
    pools: Optional[Dict[str, int]] = None
    #: model_id -> (cfg, params): models multiplexed over one fleet
    mux_models: Optional[Dict[str, Any]] = None
    #: model_id -> its admission class ("interactive" or "batch"), which
    #: overrides the request's
    model_slo: Optional[Dict[str, str]] = None
    kv_kernel: bool = True
    seed: Optional[int] = None
    _engine: Any = field(default=None, init=False, repr=False)

    def __post_init__(self):
        super().__post_init__()
        self._engine_lock = threading.Lock()
        self._static_draws = 0

    def _wants_fleet(self) -> bool:
        # pools and multiplexing are fleet concepts; a single engine serves
        # only the plain one-replica case
        return bool(self.replicas > 1 or self.max_replicas or self.pools or self.mux_models)

    def engine(self):
        """The continuous engine (or fleet), built on first use."""
        from .continuous import ContinuousBatcher
        from .fleet import EngineFleet

        engine_kwargs = dict(paged=self.paged, kv_blocks=self.kv_blocks,
                             kv_block_t=self.kv_block_t, prefill_chunk=self.prefill_chunk,
                             spec_draft=self.spec_draft, spec_k=self.spec_k,
                             kv_dtype=self.kv_dtype, kv_kernel=self.kv_kernel,
                             seed=self.seed)
        with self._engine_lock:
            if self._engine is None:
                if self._wants_fleet():
                    self._engine = EngineFleet(
                        self.cfg, self.params, replicas=self.replicas,
                        max_replicas=self.max_replicas or max(self.replicas, 1),
                        slots=self.slots, name=self.name, pools=self.pools,
                        models=self.mux_models, model_slo=self.model_slo,
                        engine_kwargs=engine_kwargs, device=self.device)
                else:
                    self._engine = ContinuousBatcher(self.cfg, self.params, slots=self.slots,
                                                     device=self.device, **engine_kwargs)
            return self._engine

    def close(self) -> None:
        with self._engine_lock:
            engine, self._engine = self._engine, None
        if engine is not None:
            engine.close()

    def predict(self, instances: Sequence[Any], deadline: Optional[float] = None,
                priority: str = "interactive", model: Optional[str] = None) -> List[Any]:
        """``model`` names the multiplexed model: required with
        ``mux_models``, refused (400) without; ``model_slo`` then sets the
        request's priority."""
        from .continuous import PREFILL_BUCKETS, _block_tile, effective_prefill_chunk

        if not instances:
            return []
        if model and not self.mux_models:
            raise HttpError(400, f"servable {self.name!r} does not multiplex models")
        if self.mux_models and not model:
            raise HttpError(400, "body must carry 'model': this servable multiplexes "
                                 f"{sorted(self.mux_models)}")
        if deadline is None:
            deadline = time.monotonic() + DEFAULT_DEADLINE_MS / 1000.0
        prompts = np.asarray(instances, dtype=np.int32)
        if prompts.ndim != 2:
            raise HttpError(400, "instances must be equal-length token-id lists")
        if prompts.shape[1] + self.max_new_tokens > self.cfg.max_seq:
            raise HttpError(413, "prompt + generation budget exceeds max_seq")
        # the engine's own chunk resolution, so routing and admission agree
        chunk = effective_prefill_chunk(
            self.prefill_chunk, self.cfg.max_seq,
            _block_tile(self.cfg.max_seq, self.kv_block_t) if self.paged else 1)
        if not self.continuous or (prompts.shape[1] > PREFILL_BUCKETS[-1] and chunk == 0):
            return self._predict_static(prompts)
        eng = self.engine()
        # hand the engine our trace context: each serving.request span
        # parents to the HTTP dispatch span
        cur = TRACER.current_span()
        tp = format_traceparent(cur) if cur is not None else None
        # a multiplexed model's class is deployment policy, not the client's
        if model and self.model_slo and model in self.model_slo:
            priority = self.model_slo[model]
        submit_kw: Dict[str, Any] = {"model": model or ""} if self._wants_fleet() else {}
        futs: List[Any] = []
        try:
            for row in prompts:
                futs.append(eng.submit(row, self.max_new_tokens,
                                       temperature=self.temperature,
                                       traceparent=tp, deadline=deadline,
                                       priority=priority, **submit_kw))
            out = []
            for row, f in zip(prompts, futs):
                remaining = max(0.0, deadline - time.monotonic())
                out.append(row.tolist() + f.result(timeout=remaining + DEADLINE_GRACE_S))
            return out
        except FleetSaturated as e:
            raise HttpError(503, f"engine saturated: {e}",
                            headers=retry_after_headers(e)) from e
        except ValueError as e:
            raise HttpError(400, str(e)) from e
        except (DeadlineExceeded, TimeoutError) as e:
            raise HttpError(504, f"deadline exceeded: {e}") from e
        except RuntimeError as e:
            raise HttpError(503, f"decode engine unavailable: {e}") from e
        finally:
            # this handler is the requests' only consumer: cancel what is
            # unfinished so the engine frees the slots
            for f in futs:
                if not f.done.is_set():
                    f.cancel()

    def _predict_static(self, prompts: np.ndarray) -> List[Any]:
        """Lockstep ``generate()`` over the batch padded to a
        ``BATCH_BUCKETS`` size with copies of the first prompt, as the JAX
        server does."""
        from ..models.gpt import generate

        n = prompts.shape[0]
        bucket = next((b for b in BATCH_BUCKETS if b >= n), None)
        if bucket is None:
            raise HttpError(413, f"batch of {n} exceeds max {BATCH_BUCKETS[-1]}")
        if bucket != n:
            prompts = np.concatenate([prompts, np.repeat(prompts[:1], bucket - n, axis=0)])
        gen = None
        if self.temperature > 0.0:
            # a fresh draw per request: a fixed generator state would repeat
            # the sample for identical prompts
            with self._engine_lock:
                self._static_draws += 1
                draw = self._static_draws
            gen = torch.Generator(device=self.device).manual_seed(
                (self.seed or 0) * 1_000_003 + draw)
        out = generate(self.cfg, self.params, prompts, self.max_new_tokens,
                       generator=gen, temperature=self.temperature, device=self.device)
        return out[:n].cpu().tolist()


def gpt_served_model(name: str = "gpt", tiny: bool = True, max_new_tokens: int = 16,
                     temperature: float = 0.0, device: DeviceLike = "cuda",
                     kv_kernel: bool = True, paged: bool = True,
                     kv_dtype: str = "bf16", prefill_chunk: Optional[int] = None,
                     seed: int = 0, replicas: int = 1,
                     params: Optional[Dict[str, torch.Tensor]] = None) -> GenerativeModel:
    """GPT text-generation servable with seeded random weights: ``tiny``
    for CPU tests, ``tiny=False`` for GPT-small (GPT-2 124M class: d768,
    12 layers, 12 heads, d_ff 3072, vocab 32000, max_seq 2048, bf16).
    ``kv_kernel`` defaults on: the served decode path writes its KV rows
    through the CUDA kernels. ``prefill_chunk`` is ``GenerativeModel``'s;
    ``replicas`` > 1 serves through an ``EngineFleet`` whose replicas share
    the one set of weights. ``params`` (``init_params(cfg, seed, device)``
    built once, on ``device``) serves weights the caller shares with other
    servables instead of drawing them again."""
    from ..models.gpt import GptConfig, init_params

    cfg = GptConfig.tiny() if tiny else GptConfig.small()
    if params is None:
        params = init_params(cfg, seed=seed, device=device)
    return GenerativeModel(
        name=name, apply_fn=None, params=params,
        cfg=cfg, max_new_tokens=max_new_tokens, temperature=temperature,
        paged=paged, kv_dtype=kv_dtype, kv_kernel=kv_kernel,
        prefill_chunk=prefill_chunk, seed=seed, replicas=replicas, device=device)


def bert_served_model(name: str = "bert", tiny: bool = True, device: DeviceLike = "cuda",
                      seed: int = 0) -> ServedModel:
    """BERT masked-LM logits servable with seeded random weights: ``tiny``
    for CPU tests, ``tiny=False`` for BERT-base (12 layers, 768 wide, 12
    heads, vocab 30522, bf16 compute). Instances are token-id lists of one
    length (int32); predictions are [L, vocab] f32 logits each. ``apply_fn``
    runs a module bound to the ``params`` it is given, bound again when a
    reload hands it other ones; concurrent requests share it read-only.
    Attention goes through ``auto_attention``: the flash kernels on the card
    at any length; on the CPU, JAX's ``full_attention``."""
    from ..models.bert import BertConfig, BertForMaskedLM, init_bert_params
    from ..ops.flash_attention import auto_attention

    cfg = BertConfig.tiny() if tiny else BertConfig.base()
    lock = threading.Lock()
    bound: Dict[str, Any] = {"params": None, "model": None}

    def apply_fn(params, ids):
        with lock:
            if bound["params"] is not params:
                bound["model"] = BertForMaskedLM.bind(cfg, params, attention_fn=auto_attention)
                bound["params"] = params
            model = bound["model"]
        return model(ids)

    return ServedModel(name=name, apply_fn=apply_fn,
                       params=init_bert_params(cfg, seed=seed, device=device),
                       input_dtype=torch.int32, device=device)


def main(argv: Optional[Sequence[str]] = None) -> None:
    """``python -m kubeflow_tpu_torch.serving.server`` — GPT-small on the
    card by default; ``--model bert`` serves BERT-base. ``--replicas`` (or
    ``FLEET_REPLICAS``) > 1 serves GPT through an engine fleet."""
    import argparse
    import os

    parser = argparse.ArgumentParser(description="PyTorch/CUDA model server")
    parser.add_argument("--model", default=os.environ.get("MODEL_NAME", "gpt"))
    parser.add_argument("--port", type=int,
                        default=int(os.environ.get("SERVING_PORT", "8500")))
    parser.add_argument("--device", default="cuda")
    parser.add_argument("--tiny", action="store_true",
                        help="serve the tiny config instead of GPT-small or BERT-base")
    parser.add_argument("--max-new-tokens", type=int, default=16)
    parser.add_argument("--replicas", type=int,
                        default=int(os.environ.get("FLEET_REPLICAS", "1")))
    args = parser.parse_args(argv)

    server = ModelServer()
    if args.model == "bert":
        server.add(bert_served_model(name=args.model, tiny=args.tiny, device=args.device))
    else:
        server.add(gpt_served_model(name=args.model, tiny=args.tiny,
                                    max_new_tokens=args.max_new_tokens,
                                    device=args.device, replicas=args.replicas))
    httpd = server.serve(args.port)
    print(f"model-server: {args.model!r} on :{httpd.port} ({args.device}, "
          f"fleet replicas={args.replicas})", flush=True)
    try:
        threading.Event().wait()
    except KeyboardInterrupt:
        pass
    finally:
        httpd.close()
        server.close()


if __name__ == "__main__":
    main()
