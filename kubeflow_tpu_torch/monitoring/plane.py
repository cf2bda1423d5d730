"""MonitoringPlane: scraper + TSDB + rule engine as one mountable unit —
the port's copy of ``kubeflow_tpu/monitoring/plane.py``.

``tick()`` is the deterministic unit (scrape pass, then rule evaluation —
tests and the e2e driver drive it directly); ``start(interval)`` runs it on
a timer thread for real deployments. ``mount(app)`` serves the aggregate:

- ``GET /federate``     — latest fresh value of every federated series,
  re-exposed in the same OpenMetrics dialect the scraper parses (so a
  higher-level collector, or our own parser in tests, can consume it),
- ``GET /debug/alerts`` — the rule engine's live alert table, via the
  process-global ``obs.register_debug_source`` registry.

``install_cluster_collector`` publishes per-node GPU capacity/allocation
gauges (``node_gpu_capacity_chips`` and ``node_gpu_allocated_chips``, the
``nvidia.com/gpu`` counts where JAX publishes ``node_tpu_*`` from
``google.com/tpu``) from any client with ``list`` into a *registry*
(scraped like any process metric).
"""

from __future__ import annotations

import logging
import threading
import time
from typing import Dict, List, Optional, Sequence

from ..runtime.metrics import METRICS, MetricsRegistry
from ..web.http import App, JsonResponse, Request
from .rules import RuleEngine
from .scrape import Scraper, Target, _format_value
from .traces import TraceCollector
from .tsdb import TSDB

log = logging.getLogger("kubeflow_tpu_torch.monitoring")


class MonitoringPlane:
    def __init__(
        self,
        client=None,
        targets: Sequence[Target] = (),
        tsdb: Optional[TSDB] = None,
        scraper: Optional[Scraper] = None,
        rules: Optional[RuleEngine] = None,
        registry: MetricsRegistry = METRICS,
        stale_after: int = 3,
        timeout_s: float = 5.0,
        traces: Optional[TraceCollector] = None,
        stragglers=None,
    ) -> None:
        self.tsdb = tsdb if tsdb is not None else TSDB()
        self.scraper = scraper if scraper is not None else Scraper(
            self.tsdb, targets=targets, client=client,
            stale_after=stale_after, timeout_s=timeout_s, registry=registry,
        )
        self.rules = rules if rules is not None else RuleEngine(
            self.tsdb, client=client, registry=registry,
        )
        # trace federation rides the same discovery + cadence as metrics;
        # optional because not every plane consumer wants the span store
        self.traces = traces
        # straggler/hang detection cross-sections the freshly scraped TSDB
        # on the same cadence (monitoring/stragglers.py); optional likewise
        self.stragglers = stragglers
        self._stop = threading.Event()
        self._thread: Optional[threading.Thread] = None

    def tick(self, now: Optional[float] = None) -> List[dict]:
        """One scrape pass then one rule evaluation; returns alert statuses."""
        now = time.time() if now is None else now
        self.scraper.scrape_once(now)
        if self.traces is not None:
            self.traces.collect_once()
        if self.stragglers is not None:
            self.stragglers.tick(now)
        return self.rules.evaluate(now)

    def start(self, interval_s: float = 5.0) -> None:
        if self._thread is not None:
            return
        self._stop.clear()

        def loop() -> None:
            while not self._stop.is_set():
                try:
                    self.tick()
                except Exception:
                    log.exception("monitoring tick failed")
                self._stop.wait(interval_s)

        self._thread = threading.Thread(target=loop, name="monitoring-plane",
                                        daemon=True)
        self._thread.start()

    def stop(self) -> None:
        self._stop.set()
        if self._thread is not None:
            self._thread.join(timeout=10)
            self._thread = None

    # -- federation ----------------------------------------------------------
    def federate_text(self) -> str:
        """Latest fresh value per federated series, grouped by family in the
        scraper's own dialect — ``parse_exposition(federate_text())`` always
        succeeds (asserted in tests), closing the compliance loop."""
        by_family: Dict[str, List[str]] = {}
        for name in self.tsdb.names():
            by_family.setdefault(self.tsdb.family_of(name), []).append(name)
        lines: List[str] = []
        for family in sorted(by_family):
            kind = self.tsdb.kind(family) or "untyped"
            names = by_family[family]
            if kind == "histogram":
                order = {f"{family}_bucket": 0, f"{family}_sum": 1,
                         f"{family}_count": 2}
                names = sorted(names, key=lambda n: order.get(n, 3))
            sample_lines: List[str] = []
            for name in names:
                for labels, _ts, value in sorted(
                    self.tsdb.latest(name), key=lambda e: sorted(e[0].items())
                ):
                    label_str = ",".join(
                        f'{k}="{v}"' for k, v in sorted(labels.items())
                    )
                    suffix = f"{{{label_str}}}" if label_str else ""
                    sample_lines.append(f"{name}{suffix} {_format_value(value)}")
            if not sample_lines:
                continue
            lines.append(f"# TYPE {family} {kind}")
            lines.extend(sample_lines)
        lines.append("# EOF")
        return "\n".join(lines) + "\n"

    def mount(self, app: App) -> App:
        from ..runtime.obs import EXPOSITION_CONTENT_TYPE, register_debug_source

        register_debug_source("alerts", lambda req: self.rules.snapshot())
        if self.stragglers is not None:
            register_debug_source(
                "stragglers", lambda req: self.stragglers.snapshot())
        if self.traces is not None:
            self.traces.mount(app)
        if any(pattern == "/federate" for _m, pattern, _fn in app.iter_routes()):
            return app

        @app.route("/federate")
        def federate(req: Request) -> JsonResponse:
            return JsonResponse(
                self.federate_text(),
                headers={"Content-Type": EXPOSITION_CONTENT_TYPE},
            )

        return app


def install_cluster_collector(client, registry: MetricsRegistry = METRICS) -> None:
    """Publish per-node GPU capacity/allocation as gauges on ``registry`` at
    every scrape: ``status.capacity["nvidia.com/gpu"]`` of each Node, and
    the ``nvidia.com/gpu`` limits of the Pods bound to it."""
    from ..gpu.topology import RESOURCE_GPU, pod_gpu_chips
    from ..scheduler.gang import name_of

    def collect() -> None:
        try:
            nodes = client.list("v1", "Node")
            pods = client.list("v1", "Pod")
        except Exception:
            log.exception("cluster collector: list failed")
            return
        for node in nodes:
            name = name_of(node)
            capacity = int(
                (node.get("status", {}).get("capacity") or {}).get(RESOURCE_GPU, 0)
            )
            if capacity <= 0:
                continue
            used = sum(
                pod_gpu_chips(p) for p in pods
                if p.get("spec", {}).get("nodeName") == name
            )
            registry.gauge("node_gpu_capacity_chips", node=name).set(float(capacity))
            registry.gauge("node_gpu_allocated_chips", node=name).set(float(used))

    registry.register_collector("cluster-gpu", collect)
