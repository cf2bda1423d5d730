"""The dashboard's monitoring views over a monitoring plane: a trimmed copy
of ``kubeflow_tpu/services/dashboard.py``.

JAX's ``TpuMetricsService.platform_overview`` (``GET
/api/metrics/platform``) joins the plane's federated data: per-target
health, the fleet-wide serving tail, the scheduler's SLIs, the goodput
and tenant accounting, the straggler plane and the slowest traced binds,
and the live alert table. :class:`PlatformViews` holds those views, method
for method, over a ``MonitoringPlane`` (or a bare ``TSDB``); callers call
them directly. Not ported: the dashboard app itself (its routes, auth,
KFAM and the workgroup flow) and the node and namespace views that read
the apiserver.
"""

from __future__ import annotations

import time
from typing import Any, Dict, List, Optional

from ..monitoring.traces import critical_path
from ..web.http import HttpError


class PlatformViews:
    """The monitoring plane's aggregate views. ``monitoring`` is a
    ``MonitoringPlane`` (its ``tsdb``, ``rules``, ``traces`` and
    ``stragglers`` are read) or a bare ``TSDB``; without one,
    :meth:`platform_overview` raises ``HttpError(503)``."""

    def __init__(self, monitoring=None):
        self.monitoring = monitoring
        self.tsdb = getattr(monitoring, "tsdb", monitoring)

    def platform_overview(self, window_s: float = 300.0) -> Dict[str, Any]:
        """The monitoring plane's aggregate view: per-target health, the
        fleet-wide serving tail over ``window_s``, and the live alert table
        — 503 without a plane (there is nothing honest to show)."""
        if self.tsdb is None:
            raise HttpError(503, "monitoring plane not wired")
        now = time.time()
        targets = []
        durations = {
            tuple(sorted(labels.items())): value
            for labels, _ts, value in self.tsdb.latest("scrape_duration_seconds",
                                                       include_stale=True)
        }
        for labels, ts, value in self.tsdb.latest("up", include_stale=True):
            targets.append({
                "instance": labels.get("instance", ""),
                "job": labels.get("job", ""),
                "up": value,
                "lastScrapeAgoSeconds": round(max(0.0, now - ts), 3),
                "scrapeDurationSeconds": durations.get(tuple(sorted(labels.items()))),
            })
        serving = {
            "ttftP99": self.tsdb.histogram_quantile(
                "serving_ttft_seconds", 0.99, window_s, now),
            "queueWaitP99": self.tsdb.histogram_quantile(
                "serving_queue_wait_seconds", 0.99, window_s, now),
            "windowSeconds": window_s,
        }
        # control-plane SLIs: the scheduler's scraped rate/bind
        # gauges plus per-queue backlog pressure, same federated source
        cycles = [v for _l, _ts, v in self.tsdb.latest("scheduler_cycles_per_sec")]
        saturation = {
            labels.get("queue", ""): value
            for labels, _ts, value in self.tsdb.latest("workqueue_saturation")
        }
        scheduler = {
            "cyclesPerSec": round(sum(cycles), 6) if cycles else None,
            "bindLatencyP99": self.tsdb.histogram_quantile(
                "scheduler_bind_latency_seconds", 0.99, window_s, now),
            "workqueueSaturation": saturation,
            "windowSeconds": window_s,
        }
        rules = getattr(self.monitoring, "rules", None)
        alerts = rules.snapshot()["alerts"] if rules is not None else []
        return {
            "targets": sorted(targets, key=lambda t: t["instance"]),
            "serving": serving,
            "scheduler": scheduler,
            "goodput": self._goodput_overview(),
            "tenants": self._tenant_overview(),
            "tracing": self._tracing_overview(),
            "stragglers": self._straggler_overview(),
            "alerts": alerts,
            "series": self.tsdb.stats(),
        }

    def _goodput_overview(self) -> Dict[str, Any]:
        """The federated goodput story: the workloads' live
        goodput fraction, the badput decomposition by bucket summed across
        instances, and serving token goodput from the waste counters."""
        fractions = {
            labels.get("workload", ""): value
            for labels, _ts, value in self.tsdb.latest(
                "training_goodput_fraction")
        }
        badput: Dict[str, float] = {}
        for labels, _ts, value in self.tsdb.latest(
                "training_badput_seconds_total"):
            bucket = labels.get("bucket", "other")
            badput[bucket] = badput.get(bucket, 0.0) + value
        goodput_s = sum(v for _l, _ts, v in self.tsdb.latest(
            "training_goodput_seconds_total"))
        delivered = sum(v for _l, _ts, v in self.tsdb.latest(
            "serving_tokens_out_total"))
        discarded = sum(v for _l, _ts, v in self.tsdb.latest(
            "serving_discarded_tail_tokens_total"))
        return {
            "trainingGoodputFraction": fractions or None,
            "trainingGoodputSeconds": round(goodput_s, 6),
            "trainingBadputSeconds": {k: round(v, 6)
                                      for k, v in sorted(badput.items())},
            "servingTokenGoodputFraction": (
                delivered / (delivered + discarded)
                if delivered + discarded > 0 else None),
        }

    def _tenant_overview(self) -> List[Dict[str, Any]]:
        """Per-namespace resource accounting: chip-seconds accrued by the
        scheduler's bind/unbind lifecycle, tokens in/out from serving."""
        chip_seconds: Dict[str, float] = {}
        for labels, _ts, value in self.tsdb.latest("tenant_chip_seconds_total"):
            ns = labels.get("namespace", "default")
            chip_seconds[ns] = chip_seconds.get(ns, 0.0) + value
        tokens: Dict[str, Dict[str, float]] = {}
        for labels, _ts, value in self.tsdb.latest("tenant_tokens_total"):
            ns = labels.get("namespace", "default")
            direction = labels.get("direction", "out")
            per = tokens.setdefault(ns, {})
            per[direction] = per.get(direction, 0.0) + value
        return [
            {"namespace": ns,
             "chipSeconds": round(chip_seconds.get(ns, 0.0), 6),
             "tokensIn": tokens.get(ns, {}).get("in", 0.0),
             "tokensOut": tokens.get(ns, {}).get("out", 0.0)}
            for ns in sorted(set(chip_seconds) | set(tokens))
        ]

    def _straggler_overview(self) -> Optional[Dict[str, Any]]:
        """The straggler plane's fleet view: per-worker skew
        scores and hang counts from the federated TSDB, plus — when the
        plane runs a StragglerDetector — its active quarantines and the
        last hang verdict. None when no straggler series have federated
        and no detector is wired."""
        scores = {
            labels.get("worker", ""): value
            for labels, _ts, value in self.tsdb.latest(
                "training_straggler_score")
        }
        hangs: Dict[str, float] = {}
        for labels, _ts, value in self.tsdb.latest(
                "training_hangs_detected_total"):
            worker = labels.get("worker", "")
            hangs[worker] = hangs.get(worker, 0.0) + value
        detector = getattr(self.monitoring, "stragglers", None)
        snap = detector.snapshot() if detector is not None else None
        if not scores and not hangs and snap is None:
            return None
        return {
            "workerScores": scores or None,
            "hangsDetected": hangs or None,
            "activeQuarantines": snap["quarantined"] if snap else [],
            "lastHangVerdict": snap["lastHangVerdict"] if snap else None,
        }

    def _tracing_overview(self) -> Optional[Dict[str, Any]]:
        """Slowest gang binds from the plane's TraceCollector, each carrying
        its critical-path decomposition — the answer to 'WHERE did that p99
        bind latency go' next to the histogram that says it exists.  None
        when the plane federates metrics but not traces."""
        collector = getattr(self.monitoring, "traces", None)
        if collector is None:
            return None
        slowest = []
        for row in collector.slowest_binds(5):
            assembled = collector.trace(row["traceId"])
            if assembled is not None:
                path = critical_path(assembled)
                if path is not None:
                    row = dict(row, criticalPath=path)
            slowest.append(row)
        return {"slowestBinds": slowest,
                "tracesFederated": len(collector.trace_ids())}
