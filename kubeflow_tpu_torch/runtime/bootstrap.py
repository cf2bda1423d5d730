"""Per-role process bootstrap: what a control-plane role's ``main`` does.

A trimmed copy of ``kubeflow_tpu/runtime/bootstrap.py``. A role connects to
the REST apiserver (``APISERVER_URL``, default the in-cluster service
name), serves ``/healthz``, ``/metrics`` and ``/debug/*`` on
``METRICS_PORT`` with its spans named after the role, and blocks until
SIGTERM or SIGINT. ``run_role`` runs reconcilers under one ``Manager``;
``install_thread_excepthook`` counts and logs a daemon thread that dies.

Not in the port yet: leader election (``ENABLE_LEADER_ELECTION``, the HA
path's ``runtime/leader.py``: setting it stops the role with
``SystemExit``) and the web apps' ``run_webapp``.
"""

from __future__ import annotations

import logging
import os
import re
import signal
import threading
from typing import Optional

from ..apiserver.remote import RemoteStore
from ..web.http import App, Request
from .manager import Manager, Reconciler

DEFAULT_APISERVER = "http://apiserver:8001"

log = logging.getLogger("kubeflow_tpu_torch.bootstrap")


def apiserver_url() -> str:
    return os.environ.get("APISERVER_URL", DEFAULT_APISERVER)


_NUM_RE = re.compile(r"\d+")


def _thread_label(name: str) -> str:
    """Collapse per-instance digits (``worker-3`` → ``worker-N``) so the
    thread label stays bounded-cardinality."""
    return _NUM_RE.sub("N", name or "unnamed")


def install_thread_excepthook() -> None:
    """Make silently-dying daemon threads observable.

    Every role runs its real work on daemon threads (manager loops,
    informers); by default an uncaught exception there prints to stderr
    and the process keeps serving /healthz with its brain gone. Hook
    ``threading.excepthook`` to log the crash and increment
    ``runtime_thread_crashes_total{thread}`` so it alerts instead.

    Idempotent; chains to the previously-installed hook.
    """
    if getattr(threading.excepthook, "_kubeflow_tpu_torch_hook", False):
        return
    from .metrics import METRICS

    prev = threading.excepthook

    def hook(args, /):
        if args.exc_type is SystemExit:
            return  # normal thread teardown, not a crash
        name = _thread_label(getattr(args.thread, "name", "") or "")
        try:
            METRICS.counter("runtime_thread_crashes_total", thread=name).inc()
        except Exception:  # noqa: BLE001 — the hook must never raise
            pass
        log.error(
            "thread %r crashed",
            getattr(args.thread, "name", "?"),
            exc_info=(args.exc_type, args.exc_value, args.exc_traceback),
        )
        # chain to a custom predecessor, but not the stock stderr printer —
        # the log.error above already carries the traceback
        if prev not in (None, threading.__excepthook__) and not getattr(
                prev, "_kubeflow_tpu_torch_hook", False):
            try:
                prev(args)
            except Exception:  # noqa: BLE001 — a broken chained hook stays contained
                pass

    hook._kubeflow_tpu_torch_hook = True
    threading.excepthook = hook


def connect(url: Optional[str] = None, timeout: float = 60.0) -> RemoteStore:
    store = RemoteStore(url or apiserver_url())
    store.wait_ready(timeout=timeout)
    return store


def serve_ops_endpoints(name: str, port: Optional[int] = None):
    """/healthz + the observability server every role exposes
    (``/metrics``, ``/debug/traces``, ``/debug/vars``, ...)."""
    from .obs import mount_observability
    from .tracing import TRACER

    # The process-global tracer takes the role's identity: federated spans
    # carry service.name=<role> so the TraceCollector can tell which
    # process each hop of an assembled trace ran in.
    TRACER.service = name

    app = App(f"{name}-ops")

    @app.route("/healthz")
    def healthz(req: Request):
        return {"status": "ok", "role": name}

    mount_observability(app)

    if port is None:
        port = int(os.environ.get("METRICS_PORT", "8080"))
    # 0.0.0.0: kubelet probes and Prometheus scrape via the pod IP.
    return app.serve(port, host="0.0.0.0")


def block_forever() -> None:
    """Park the main thread until SIGTERM/SIGINT (daemon threads do the work)."""
    stop = threading.Event()

    def handler(signum, frame):
        stop.set()

    for sig in (signal.SIGTERM, signal.SIGINT):
        try:
            signal.signal(sig, handler)
        except ValueError:  # non-main thread (tests)
            break
    stop.wait()


def run_role(name: str, *reconcilers: Reconciler, url: Optional[str] = None) -> None:
    """Standard controller-role main: connect, reconcile, expose ops, block."""
    logging.basicConfig(level=os.environ.get("LOG_LEVEL", "INFO"))
    if os.environ.get("ENABLE_LEADER_ELECTION", "").strip().lower() in ("1", "true", "yes", "on"):
        raise SystemExit("ENABLE_LEADER_ELECTION: the port has no leader election "
                         "(runtime/leader.py, the HA path); unset it")
    install_thread_excepthook()
    store = connect(url)
    mgr = Manager(store=store)
    for rec in reconcilers:
        mgr.add(rec)
    mgr.start()
    ops = None
    try:
        try:
            ops = serve_ops_endpoints(name)
        except OSError as e:
            # a port collision on a shared host must not crash a role whose
            # manager threads already run
            log.warning("%s: ops endpoints unavailable (%s); running without /metrics",
                        name, e)
        log.info("%s running against %s (ops %s)", name, store.base_url,
                 f":{ops.port}" if ops else "disabled")
        block_forever()
    finally:
        mgr.stop()
        if ops is not None:
            ops.close()
