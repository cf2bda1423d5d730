"""Tiny threaded HTTP app: routing with path params and JSON bodies.

A trimmed copy of ``kubeflow_tpu/web/http.py`` — ``App``, ``HttpError``,
``Request``, ``StreamingResponse`` and the threaded server — enough for the
model server's predict surface, the observability routes
(``runtime/obs.py``) and the apiserver's REST and NDJSON watch streams
(``apiserver/server.py``). Route
patterns use ``<name>`` segments, inline ones too
(``/v1/models/<name>:predict``). A ``JsonResponse`` body that is ``bytes``,
or a ``str`` under a non-JSON ``Content-Type`` (the ``/metrics``
exposition), goes out as it is. Servers bind port 0 in tests and expose
``server.port``.
"""

from __future__ import annotations

import json
import logging
import re
import threading
from dataclasses import dataclass, field
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from typing import Any, Callable, Dict, List, Optional, Tuple
from urllib.parse import parse_qs, urlparse

from ..runtime.tracing import TRACER, format_traceparent

log = logging.getLogger("kubeflow_tpu_torch.web")


class HttpError(Exception):
    """``headers`` ride onto the error response (e.g. ``Retry-After``)."""

    def __init__(self, status: int, message: str,
                 headers: Optional[Dict[str, str]] = None):
        super().__init__(message)
        self.status = status
        self.message = message
        self.headers = dict(headers or {})


@dataclass
class Request:
    method: str
    path: str
    query: Dict[str, List[str]]
    headers: Dict[str, str]
    body: bytes
    params: Dict[str, str] = field(default_factory=dict)

    @property
    def json(self) -> Any:
        if not self.body:
            return None
        try:
            return json.loads(self.body)
        except json.JSONDecodeError:
            raise HttpError(400, "invalid JSON body") from None

    def header(self, name: str, default: str = "") -> str:
        return self.headers.get(name.lower(), default)

    def query1(self, name: str, default: str = "") -> str:
        vals = self.query.get(name)
        return vals[0] if vals else default


@dataclass
class JsonResponse:
    body: Any = None
    status: int = 200
    headers: Dict[str, str] = field(default_factory=dict)

    @property
    def content_type(self) -> str:
        for k, v in self.headers.items():
            if k.lower() == "content-type":
                return v
        return "application/json"

    def encode(self) -> bytes:
        if self.body is None:
            return b""
        if isinstance(self.body, bytes):
            return self.body
        if isinstance(self.body, str) and not self.content_type.startswith("application/json"):
            return self.body.encode()
        return json.dumps(self.body).encode()


@dataclass
class StreamingResponse:
    """A chunked response (the apiserver's NDJSON watch streams).
    ``chunks`` yields bytes; ``on_close`` runs once the stream ends or the
    client goes away."""

    chunks: Any  # Iterator[bytes]
    status: int = 200
    headers: Dict[str, str] = field(default_factory=dict)
    on_close: Optional[Callable[[], None]] = None

    @property
    def content_type(self) -> str:
        for k, v in self.headers.items():
            if k.lower() == "content-type":
                return v
        return "application/json"


Handler = Callable[[Request], Any]


def _compile(pattern: str) -> re.Pattern:
    """``<name>`` params may appear inline; they match neither ``/`` nor
    ``:``."""
    parts = re.split(r"(<[a-zA-Z_][a-zA-Z0-9_]*>)", pattern)
    out = []
    for part in parts:
        if part.startswith("<") and part.endswith(">"):
            out.append(f"(?P<{part[1:-1]}>[^/:]+)")
        else:
            out.append(re.escape(part))
    return re.compile("^" + "".join(out) + "/?$")


class App:
    def __init__(self, name: str = "app"):
        self.name = name
        self._routes: List[Tuple[str, str, re.Pattern, Handler]] = []

    def route(self, pattern: str,
              methods: Tuple[str, ...] = ("GET",)) -> Callable[[Handler], Handler]:
        rx = _compile(pattern)

        def deco(fn: Handler) -> Handler:
            for m in methods:
                self._routes.append((m.upper(), pattern, rx, fn))
            return fn

        return deco

    def iter_routes(self):
        """(method, pattern, handler) triples in registration order."""
        for method, pattern, _rx, fn in self._routes:
            yield method, pattern, fn

    def dispatch(self, req: Request) -> "JsonResponse | StreamingResponse":
        with TRACER.span(
            f"{self.name} {req.method}",
            traceparent=req.header("traceparent") or None,
            **{"http.method": req.method, "http.target": req.path, "app": self.name},
        ) as span:
            resp = self._dispatch_inner(req)
            span.set("http.status_code", resp.status)
            # echo the handler span so callers can join client + server
            # timelines
            resp.headers.setdefault("traceparent", format_traceparent(span))
            if isinstance(resp, StreamingResponse):
                span.set("http.streaming", True)  # the span closes as the stream starts
            elif resp.status >= 500:
                span.status = "ERROR"
                span.status_message = f"HTTP {resp.status}"
            return resp

    def _dispatch_inner(self, req: Request) -> "JsonResponse | StreamingResponse":
        try:
            for method, _pattern, rx, fn in self._routes:
                if method != req.method:
                    continue
                m = rx.match(req.path)
                if m:
                    req.params = m.groupdict()
                    result = fn(req)
                    if isinstance(result, (JsonResponse, StreamingResponse)):
                        return result
                    return JsonResponse(result)
            if any(rx.match(req.path) for _, _, rx, _ in self._routes):
                raise HttpError(405, f"method {req.method} not allowed")
            raise HttpError(404, f"no route for {req.path}")
        except HttpError as e:
            return JsonResponse({"error": e.message, "status": e.status},
                                status=e.status, headers=dict(e.headers))
        except Exception:
            log.exception("%s: handler error %s %s", self.name, req.method, req.path)
            return JsonResponse({"error": "internal error", "status": 500}, status=500)

    def serve(self, port: int = 0, host: str = "127.0.0.1") -> "AppServer":
        return AppServer(self, host, port)


class AppServer:
    def __init__(self, app: App, host: str, port: int):
        self.app = app
        outer = self

        class _Handler(BaseHTTPRequestHandler):
            protocol_version = "HTTP/1.1"

            def log_message(self, *a):  # quiet
                pass

            def _handle(self) -> None:
                length = int(self.headers.get("Content-Length") or 0)
                body = self.rfile.read(length) if length else b""
                parsed = urlparse(self.path)
                req = Request(
                    method=self.command,
                    path=parsed.path,
                    query=parse_qs(parsed.query),
                    headers={k.lower(): v for k, v in self.headers.items()},
                    body=body,
                )
                resp = outer.app.dispatch(req)
                if isinstance(resp, StreamingResponse):
                    self._stream(resp)
                    return
                payload = resp.encode()
                self.send_response(resp.status)
                self.send_header("Content-Type", resp.content_type)
                self.send_header("Content-Length", str(len(payload)))
                for k, v in resp.headers.items():
                    if k.lower() != "content-type":
                        self.send_header(k, v)
                self.end_headers()
                self.wfile.write(payload)

            def _stream(self, resp: StreamingResponse) -> None:
                self.send_response(resp.status)
                self.send_header("Content-Type", resp.content_type)
                self.send_header("Transfer-Encoding", "chunked")
                for k, v in resp.headers.items():
                    if k.lower() != "content-type":
                        self.send_header(k, v)
                self.end_headers()
                try:
                    for chunk in resp.chunks:
                        if not chunk:
                            continue
                        self.wfile.write(f"{len(chunk):x}\r\n".encode() + chunk + b"\r\n")
                        self.wfile.flush()
                    self.wfile.write(b"0\r\n\r\n")
                except OSError:
                    pass  # the client went away: a watch's normal end
                finally:
                    if resp.on_close:
                        try:
                            resp.on_close()
                        except Exception:
                            log.exception("%s: stream on_close failed", outer.app.name)

            do_GET = do_POST = do_PUT = do_PATCH = do_DELETE = _handle

        class _Server(ThreadingHTTPServer):
            # an overloaded server must answer 503/504, not RST at the TCP
            # layer: the default backlog of 5 resets connection bursts
            request_queue_size = 128

        self.httpd = _Server((host, port), _Handler)
        self.port = self.httpd.server_address[1]
        self._thread = threading.Thread(
            target=self.httpd.serve_forever, name=f"{app.name}-http", daemon=True)
        self._thread.start()

    def close(self) -> None:
        self.httpd.shutdown()
        self.httpd.server_close()
