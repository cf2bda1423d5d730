"""Observability e2e over real HTTP: the port of ``e2e/observability_driver.py``.

Serves GPT-tiny (seeded weights, paged continuous engine) behind
``ModelServer`` on port 0, sends ONE request carrying a fixed W3C
``traceparent``, then asserts that the plane saw it:

1. ``/metrics`` carries nonzero ``serving_ttft_seconds``,
   ``serving_inter_token_seconds`` and ``serving_queue_wait_seconds``
   histograms, with the client's trace id as an exemplar;
2. ``/debug/traces?trace_id=...`` returns ONE ``serving.request`` span,
   parented to the ``model-server`` handler span, which is parented to the
   client's span, with the events enqueued → admitted → prefill_done →
   first_token → retired in order.

``run(device=...)`` returns the report (JAX's keys); ``main`` prints it as
one JSON line and exits 0, or prints ``{"ok": false, "error": ...}`` and
exits 1. On the card: ``python -m kubeflow_tpu_torch.e2e.observability_driver``.
"""

from __future__ import annotations

import json
import sys
import urllib.request
from typing import Any, Dict

from ..device import DeviceLike
from ._http import get

CLIENT_TRACE_ID = "ab" * 16
CLIENT_SPAN_ID = "cd" * 8
TRACEPARENT = f"00-{CLIENT_TRACE_ID}-{CLIENT_SPAN_ID}-01"

SLO_HISTOGRAMS = (
    "serving_ttft_seconds",
    "serving_inter_token_seconds",
    "serving_queue_wait_seconds",
)


def run(device: DeviceLike = "cuda") -> Dict[str, Any]:
    from ..serving.server import ModelServer, gpt_served_model

    model = gpt_served_model(tiny=True, max_new_tokens=8, device=device)
    server = ModelServer()
    server.add(model)
    httpd = server.serve(0)
    base = f"http://127.0.0.1:{httpd.port}"
    try:
        payload = json.dumps({"instances": [[1, 2, 3, 4]]}).encode()
        req = urllib.request.Request(
            f"{base}/v1/models/gpt:predict", payload,
            {"content-type": "application/json", "traceparent": TRACEPARENT})
        with urllib.request.urlopen(req, timeout=120) as resp:
            body = json.loads(resp.read())
        assert body["predictions"] and len(body["predictions"][0]) == 4 + 8, body

        # -- scrape ----------------------------------------------------------
        text = get(f"{base}/metrics").decode()
        for name in SLO_HISTOGRAMS:
            count = next(
                (float(ln.rsplit(" ", 1)[1]) for ln in text.splitlines()
                 if ln.startswith(f"{name}_count")), 0.0)
            assert count > 0, f"{name}_count not nonzero in scrape"
            assert f'trace_id="{CLIENT_TRACE_ID}"' in text, \
                f"no exemplar with the client trace id near {name}"

        # -- trace tree ------------------------------------------------------
        doc = json.loads(get(f"{base}/debug/traces?trace_id={CLIENT_TRACE_ID}"))
        spans = doc["resourceSpans"][0]["scopeSpans"][0]["spans"]
        by_id = {s["spanId"]: s for s in spans}
        request_spans = [s for s in spans if s["name"] == "serving.request"]
        assert len(request_spans) == 1, f"want 1 serving.request, got {len(request_spans)}"
        rs = request_spans[0]
        events = [e["name"] for e in rs.get("events", [])]
        want = ["enqueued", "admitted", "prefill_done", "first_token", "retired"]
        assert [e for e in events if e in want] == want, f"event set {events}"
        # serving.request -> HTTP handler -> the client's traceparent
        handler = by_id.get(rs.get("parentSpanId", ""))
        assert handler is not None and handler["name"].startswith("model-server"), \
            f"serving.request not parented to the HTTP handler: {rs.get('parentSpanId')}"
        assert handler.get("parentSpanId") == CLIENT_SPAN_ID, \
            "handler span not parented to the client traceparent"
        return {
            "ok": True,
            "trace_id": CLIENT_TRACE_ID,
            "spans": len(spans),
            "events": events,
            "generated": len(body["predictions"][0]),
        }
    finally:
        httpd.close()
        model.close()


def main() -> int:
    try:
        report = run()
    except AssertionError as e:
        print(json.dumps({"ok": False, "error": str(e)}))
        return 1
    print(json.dumps(report))
    return 0


if __name__ == "__main__":
    sys.exit(main())
