"""Model server of the port: the TF-Serving-compatible predict surface.

API shape (the same as ``kubeflow_tpu/serving/server.py``):
    POST /v1/models/<name>:predict   {"instances": [...]}
    ->                               {"predictions": [...]}
    GET  /v1/models/<name>           status/metadata
    GET  /healthz

``GenerativeModel`` serves autoregressive generation through the
continuous-batching engine; ``gpt_served_model`` builds GPT-small (or the
tiny config) with seeded random weights. ``python -m
kubeflow_tpu_torch.serving.server`` runs it on the card.
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
from ..runtime.tracing import TRACER, format_traceparent
from ..web.http import App, HttpError, Request
from .errors import DeadlineExceeded, FleetSaturated

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


@dataclass
class ServedModel:
    """One deployable model: ``apply(params, batch) -> out`` run eagerly."""

    name: str
    apply_fn: Optional[Callable[[Any, torch.Tensor], torch.Tensor]]
    params: Any
    version: str = "1"

    def predict(self, instances: Sequence[Any]) -> List[Any]:
        if not instances:
            return []
        with torch.no_grad():
            out = self.apply_fn(self.params, torch.as_tensor(np.asarray(instances)))
        return out.cpu().tolist()

    def close(self) -> None:
        pass


class ModelServer:
    """Hosts ServedModels over the predict API; servable with serve()."""

    def __init__(self):
        self.models: Dict[str, ServedModel] = {}
        self.app = App("model-server")
        self._register_routes()

    def add(self, model: ServedModel) -> "ModelServer":
        self.models[model.name] = model
        return self

    def close(self) -> None:
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
            t0 = time.perf_counter()
            try:
                if isinstance(model, GenerativeModel):
                    predictions = model.predict(instances, deadline=deadline,
                                                priority=priority)
                else:
                    predictions = model.predict(instances)
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
    sequences (prompt + ``max_new_tokens``). Requests go through one
    continuous-batching engine built on first use. Prompts longer than the
    engine's largest prefill bucket are refused with 413 until chunked
    prefill is ported (ROADMAP.md queue A, item 4)."""

    cfg: Any = None
    max_new_tokens: int = 16
    temperature: float = 0.0
    slots: int = 8
    paged: bool = True
    kv_dtype: str = "bf16"
    kv_kernel: bool = True
    seed: Optional[int] = None
    device: DeviceLike = "cuda"
    _engine: Any = field(default=None, init=False, repr=False)

    def __post_init__(self):
        self.device = resolve_device(self.device)
        self._engine_lock = threading.Lock()

    def engine(self):
        from .continuous import ContinuousBatcher

        with self._engine_lock:
            if self._engine is None:
                self._engine = ContinuousBatcher(
                    self.cfg, self.params, slots=self.slots, paged=self.paged,
                    kv_dtype=self.kv_dtype, kv_kernel=self.kv_kernel,
                    seed=self.seed, device=self.device)
            return self._engine

    def close(self) -> None:
        with self._engine_lock:
            engine, self._engine = self._engine, None
        if engine is not None:
            engine.close()

    def predict(self, instances: Sequence[Any], deadline: Optional[float] = None,
                priority: str = "interactive") -> List[Any]:
        from .continuous import PREFILL_BUCKETS

        if not instances:
            return []
        if deadline is None:
            deadline = time.monotonic() + DEFAULT_DEADLINE_MS / 1000.0
        prompts = np.asarray(instances, dtype=np.int32)
        if prompts.ndim != 2:
            raise HttpError(400, "instances must be equal-length token-id lists")
        if prompts.shape[1] + self.max_new_tokens > self.cfg.max_seq:
            raise HttpError(413, "prompt + generation budget exceeds max_seq")
        if prompts.shape[1] > PREFILL_BUCKETS[-1]:
            raise HttpError(413, f"prompt of {prompts.shape[1]} tokens exceeds the "
                                 f"largest prefill bucket {PREFILL_BUCKETS[-1]}; "
                                 "chunked prefill is ROADMAP.md queue A, item 4")
        eng = self.engine()
        # hand the engine our trace context: each serving.request span
        # parents to the HTTP dispatch span
        cur = TRACER.current_span()
        tp = format_traceparent(cur) if cur is not None else None
        futs: List[Any] = []
        try:
            for row in prompts:
                futs.append(eng.submit(row, self.max_new_tokens,
                                       temperature=self.temperature,
                                       traceparent=tp, deadline=deadline,
                                       priority=priority))
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


def gpt_served_model(name: str = "gpt", tiny: bool = True, max_new_tokens: int = 16,
                     temperature: float = 0.0, device: DeviceLike = "cuda",
                     kv_kernel: bool = True, paged: bool = True,
                     kv_dtype: str = "bf16", seed: int = 0) -> GenerativeModel:
    """GPT text-generation servable with seeded random weights: ``tiny``
    for CPU tests, ``tiny=False`` for GPT-small (GPT-2 124M class: d768,
    12 layers, 12 heads, d_ff 3072, vocab 32000, max_seq 2048, bf16).
    ``kv_kernel`` defaults on: the served decode path writes its KV rows
    through the CUDA kernels."""
    from ..models.gpt import GptConfig, init_params

    cfg = GptConfig.tiny() if tiny else GptConfig.small()
    return GenerativeModel(
        name=name, apply_fn=None, params=init_params(cfg, seed=seed, device=device),
        cfg=cfg, max_new_tokens=max_new_tokens, temperature=temperature,
        paged=paged, kv_dtype=kv_dtype, kv_kernel=kv_kernel,
        seed=seed, device=device)


def main(argv: Optional[Sequence[str]] = None) -> None:
    """``python -m kubeflow_tpu_torch.serving.server`` — GPT-small on the
    card by default."""
    import argparse
    import os

    parser = argparse.ArgumentParser(description="PyTorch/CUDA model server")
    parser.add_argument("--model", default=os.environ.get("MODEL_NAME", "gpt"))
    parser.add_argument("--port", type=int,
                        default=int(os.environ.get("SERVING_PORT", "8500")))
    parser.add_argument("--device", default="cuda")
    parser.add_argument("--tiny", action="store_true",
                        help="serve the tiny config instead of GPT-small")
    parser.add_argument("--max-new-tokens", type=int, default=16)
    args = parser.parse_args(argv)

    server = ModelServer()
    server.add(gpt_served_model(name=args.model, tiny=args.tiny,
                                max_new_tokens=args.max_new_tokens,
                                device=args.device))
    httpd = server.serve(args.port)
    print(f"model-server: {args.model!r} on :{httpd.port} ({args.device})", flush=True)
    try:
        threading.Event().wait()
    except KeyboardInterrupt:
        pass
    finally:
        httpd.close()
        server.close()


if __name__ == "__main__":
    main()
