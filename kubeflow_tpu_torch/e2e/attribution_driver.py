"""Attribution-plane e2e: a live train loop, profiled over real HTTP. The
port of ``e2e/attribution_driver.py``.

Runs a tiny train step (``w - 0.01 * tanh(x @ w).T @ x / n``) under a
``StepClock`` with the full phase set (data_wait / compute / fetch; compute
ends at a device synchronize), registers the clock at ``/debug/profile``,
mounts observability on a real server, then asserts:

1. ``GET /debug/profile`` returns JSON that ``json.loads`` cleanly and is
   Chrome-trace-loadable: a ``traceEvents`` list with >= 1 complete
   ("ph": "X") event per step phase per captured step plus one per step,
2. capture-on-demand: ``?steps=N&timeout=S`` issued BEFORE the steps run
   blocks until N fresh steps exist and returns exactly their events,
3. ``/metrics`` carries a nonzero ``training_step_peak_hbm_bytes`` gauge
   (the step's footprint from ``price_callable``'s meta-device run, the
   analog of XLA's memory analysis, so it holds on the CPU too),
4. the attribution report's fraction decomposition sums to 1 and its
   measured phases reconstruct the StepClock step within 5%.

``run(device=...)`` returns the report; ``main`` prints it as one JSON
line and exits 0, or prints ``{"ok": false, "error": ...}`` and exits 1.
On the CPU: ``run(device="cpu")`` (the attribution's peaks are then the
catalog's H100 entry); on the card: ``python -m
kubeflow_tpu_torch.e2e.attribution_driver``.
"""

from __future__ import annotations

import json
import sys
import threading
import time
import urllib.request
from typing import Any, Dict

from ..device import DeviceLike

STEPS = 4
PHASES = ("data_wait", "compute", "fetch")


def _get(url: str) -> bytes:
    with urllib.request.urlopen(url, timeout=60) as resp:
        return resp.read()


def run(device: DeviceLike = "cuda") -> Dict[str, Any]:
    import torch

    from ..device import resolve_device
    from ..gpu.profiling import StepClock, register_profile_clock
    from ..runtime.metrics import METRICS
    from ..runtime.obs import mount_observability
    from ..runtime.tracing import TRACER
    from ..training.attribution import (attribution_report, footprint, loop_generation,
                                        price_callable, record_step_peak_hbm)
    from ..web.http import App

    dev = resolve_device(device)
    generation = loop_generation(dev)

    def train_step(w: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
        return w - 0.01 * torch.tanh(x @ w).T @ x / x.shape[0]

    g = torch.Generator().manual_seed(0)
    w = torch.randn(64, 64, generator=g).to(dev)
    x = torch.randn(32, 64, generator=torch.Generator().manual_seed(1)).to(dev)

    clock = register_profile_clock(
        StepClock(metrics=METRICS.namespace("training"), tracer=TRACER))
    record_step_peak_hbm(footprint(train_step, w, x))

    def step(w: torch.Tensor) -> torch.Tensor:
        with clock.data_wait():
            time.sleep(0.001)  # stands in for the input pipeline
        with clock.compute():
            w = train_step(w, x)
            if dev.type == "cuda":
                torch.cuda.synchronize(dev)
        with clock.fetch():
            float(w.sum())
        clock.end_step()
        return w

    app = App("attribution-e2e")
    mount_observability(app)
    httpd = app.serve(0)
    base = f"http://127.0.0.1:{httpd.port}"
    try:
        for _ in range(STEPS):
            w = step(w)

        # -- 1: snapshot profile is valid Chrome trace -----------------------
        doc = json.loads(_get(f"{base}/debug/profile?steps={STEPS}"))
        events = doc["traceEvents"]
        assert doc.get("displayTimeUnit") == "ms", doc.keys()
        complete = [e for e in events if e.get("ph") == "X"]
        for e in complete:
            assert {"name", "ts", "dur", "pid", "tid"} <= set(e), e
        step_events = [e for e in complete if e.get("cat") == "step"]
        assert len(step_events) == STEPS, (len(step_events), STEPS)
        for phase in PHASES:
            n = sum(1 for e in complete
                    if e.get("cat") == "phase" and e["name"] == phase)
            assert n >= STEPS, f"phase {phase}: {n} events < {STEPS} steps"

        # -- 2: capture-on-demand waits for FRESH steps ----------------------
        fresh = 2
        captured = {}

        def capture():
            captured["doc"] = json.loads(
                _get(f"{base}/debug/profile?steps={fresh}&timeout=30"))

        t = threading.Thread(target=capture)
        t.start()
        time.sleep(0.2)  # request must be in its polling wait before we step
        for _ in range(fresh):
            w = step(w)
        t.join(timeout=60)
        assert not t.is_alive(), "on-demand capture never returned"
        got = [e for e in captured["doc"]["traceEvents"]
               if e.get("ph") == "X" and e.get("cat") == "step"]
        assert len(got) == fresh, (len(got), fresh)

        # -- 3: HBM gauge in the exposition ----------------------------------
        text = _get(f"{base}/metrics").decode()
        peak = next((float(ln.rsplit(" ", 1)[1]) for ln in text.splitlines()
                     if ln.startswith("training_step_peak_hbm_bytes")), 0.0)
        assert peak > 0, "training_step_peak_hbm_bytes missing or zero"

        # -- 4: attribution fractions reconstruct the measured step ----------
        cost = price_callable(train_step, w, x, name="train_step", kind="step",
                              generation=generation)
        report = attribution_report([cost], clock=clock, generation=generation)
        frac_sum = sum(report.fractions.values())
        assert abs(frac_sum - 1.0) < 1e-6, report.fractions
        reconstructed = sum(report.measured.values())
        assert abs(reconstructed - report.step_seconds) \
            <= 0.05 * report.step_seconds, (reconstructed, report.step_seconds)
        return {
            "ok": True,
            "steps": STEPS + fresh,
            "trace_events": len(events),
            "peak_hbm_bytes": peak,
            "fractions": {k: round(v, 4) for k, v in report.fractions.items()},
            "step_seconds": round(report.step_seconds, 6),
        }
    finally:
        httpd.close()


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
