"""python -m kubeflow_tpu_torch.apiserver — the REST control-plane server.

Serves an open, in-memory ``Store`` (``DictBackend``) on ``API_PORT``
(default 8001) with the GC sweep running, its spans named
``service.name=apiserver``. The port of ``kubeflow_tpu/apiserver/__main__.py``
without the switches whose parts are not ported yet: each of them, when
set, stops the process with ``SystemExit`` naming what is missing, rather
than serve a store that ignores it.

- ``APISERVER_WAL_DIR`` (the durable WAL backend) and
  ``KUBEFLOW_TPU_NATIVE=1`` (the C++ storage core) — the HA path;
- ``APISERVER_AUTH`` (token/RBAC), ``APISERVER_FAIRNESS`` (priority and
  fairness), ``APISERVER_TLS_CERT_FILE``/``APISERVER_TLS_KEY_FILE`` — the
  auth, TLS and fairness path;
- ``WEBHOOK_URL`` (an external PodDefault webhook) — the notebook path,
  which also brings the in-process PodDefault admission hook (not
  registered here).
"""

from __future__ import annotations

import logging
import os
from typing import Dict, Optional

from ..runtime.bootstrap import block_forever
from .server import make_apiserver_app, run_gc_loop
from .store import Store

#: env switch -> the part of the JAX package it needs, for the refusal
_NOT_PORTED = {
    "APISERVER_WAL_DIR": "the durable WAL backend (apiserver/wal.py, the HA path)",
    "APISERVER_AUTH": "the token/RBAC gate (apiserver/auth.py, the auth, TLS and "
                      "fairness path)",
    "APISERVER_FAIRNESS": "priority and fairness (apiserver/fairness.py, the auth, TLS "
                          "and fairness path)",
    "APISERVER_TLS_CERT_FILE": "TLS (web/tls.py, the auth, TLS and fairness path)",
    "APISERVER_TLS_KEY_FILE": "TLS (web/tls.py, the auth, TLS and fairness path)",
    "WEBHOOK_URL": "admission webhooks (webhook/poddefault.py, the notebook path)",
}

#: values that leave a switch off
_OFF = ("", "0", "false", "off", "no")


def refuse_unported(env: Optional[Dict[str, str]] = None) -> None:
    """Raise ``SystemExit`` when ``env`` (default ``os.environ``) sets a
    switch whose part of the apiserver the port does not have yet."""
    env = os.environ if env is None else env
    on = [k for k in _NOT_PORTED if env.get(k, "").strip().lower() not in _OFF]
    if env.get("KUBEFLOW_TPU_NATIVE", "").strip() == "1":
        raise SystemExit("KUBEFLOW_TPU_NATIVE=1: the port's apiserver has no native storage "
                         "core (native/store_core.cc, the HA path); unset it")
    if on:
        raise SystemExit("the port's apiserver does not have " + "; ".join(
            f"{k} → {_NOT_PORTED[k]}" for k in on) + "; unset " + ", ".join(on))


def main() -> None:
    logging.basicConfig(level=os.environ.get("LOG_LEVEL", "INFO"))
    refuse_unported()
    from ..runtime.tracing import TRACER

    TRACER.service = "apiserver"  # federated spans name their process
    store = Store()
    app = make_apiserver_app(store)
    run_gc_loop(store)
    server = app.serve(int(os.environ.get("API_PORT", "8001")), host="0.0.0.0")
    logging.getLogger("kubeflow_tpu_torch.apiserver").info(
        "apiserver on :%d (plain HTTP, backend=%s, open)", server.port,
        type(store.backend).__name__)
    try:
        block_forever()
    finally:
        server.close()


if __name__ == "__main__":
    main()
