"""SLO-driven fleet autoscaler — the port of ``kubeflow_tpu/serving/autoscaler.py``.

The engine exports ``serving_ttft_seconds``, ``serving_queue_wait_seconds``
and ``serving_inter_token_seconds`` histograms; this module turns their
tail quantiles into replica-count decisions, with hysteresis so that a
quantile riding the boundary cannot flap the fleet.

The quantiles are windowed: each ``tick()`` snapshots the registry's
cumulative bucket counts (``MetricsRegistry.histogram_counts``) and
quantiles the delta since the previous tick, so one old breach does not
hold the fleet up forever.

Hysteresis (``AutoscalerConfig``): scale up after ``breach_ticks``
consecutive windows above the SLO; scale down after ``idle_ticks``
consecutive windows with no traffic or below ``scale_down_margin * SLO``;
the band between holds (both streaks reset); ``cooldown_ticks`` after any
action before the next. A disaggregated fleet (``fleet.pools``) runs one
such state machine per pool: prefill on the TTFT quantile, decode on the
inter-token one.

The source is pluggable (``source=``): ``RegistryWindowSource`` (the
default) windows the in-process registry; ``FederatedWindowSource``
windows the fleet-wide histograms the monitoring plane scraped into its
TSDB (``monitoring/tsdb.py``), and reports a scrape gap as stale, which
holds the fleet.
"""

from __future__ import annotations

import logging
import threading
from dataclasses import dataclass
from typing import Dict, List, Optional, Tuple

from ..runtime.metrics import METRICS, quantile_from_counts

TTFT_METRIC = "serving_ttft_seconds"
QUEUE_WAIT_METRIC = "serving_queue_wait_seconds"
INTER_TOKEN_METRIC = "serving_inter_token_seconds"

LOG = logging.getLogger(__name__)


@dataclass
class AutoscalerConfig:
    ttft_slo: float = 1.0          # p-q TTFT ceiling (seconds)
    queue_wait_slo: float = 0.5    # p-q queue-wait ceiling (seconds)
    #: p-q inter-token ceiling: the decode pool's SLO on a disaggregated fleet
    inter_token_slo: float = 0.1
    quantile: float = 0.99
    scale_down_margin: float = 0.5  # idle iff p-q < margin * SLO (or no traffic)
    breach_ticks: int = 2
    idle_ticks: int = 3
    cooldown_ticks: int = 2


@dataclass
class _Window:
    """One tick's view of one SLO histogram. ``stale``: the source could
    not give a trustworthy window, which holds the fleet; ``value is None``
    with fresh data means no traffic, which counts toward scale-down."""
    value: Optional[float]  # windowed quantile; None with no traffic/window
    samples: int
    stale: bool = False


class RegistryWindowSource:
    """Snapshot the registry's cumulative bucket counts each tick and
    quantile the delta since the previous one."""

    name = "registry"

    def __init__(self, registry=METRICS):
        self._registry = registry
        self._prev: Dict[str, Tuple[List[int], int]] = {}

    def window(self, metric: str, q: float) -> _Window:
        snap = self._registry.histogram_counts(metric)
        if snap is None:
            return _Window(None, 0)
        buckets, counts, total = snap
        prev = self._prev.get(metric)
        self._prev[metric] = (counts, total)
        if prev is None:
            return _Window(None, 0)  # first sight: no window yet
        dcounts = [c - p for c, p in zip(counts, prev[0])]
        dtotal = total - prev[1]
        if dtotal <= 0:
            return _Window(None, 0)
        return _Window(quantile_from_counts(buckets, dcounts, dtotal, q), dtotal)


class FederatedWindowSource:
    """Scrape-backed source: quantile the FLEET-WIDE histograms out of the
    monitoring plane's TSDB instead of whatever registry happens to share
    the autoscaler's process. Sums the latest fresh ``<metric>_bucket``
    value per ``le`` across instances and windows the delta between ticks.

    Staleness is first-class: when the scraper stopped delivering (no fresh
    series, or the newest sample timestamp did not advance since the last
    tick), the window reports ``stale=True`` and the autoscaler HOLDS — a
    scrape gap must never read as "the fleet went idle" (the no-flap
    regression)."""

    name = "federated"

    def __init__(self, tsdb, matchers: Optional[Dict] = None):
        self.tsdb = tsdb
        self.matchers = matchers
        #: metric → (per-le cumulative sums, newest sample ts)
        self._prev: Dict[str, Tuple[Dict[float, float], float]] = {}

    def _cumulative(self, metric: str) -> Tuple[Dict[float, float], Optional[float]]:
        per_le: Dict[float, float] = {}
        newest: Optional[float] = None
        for labels, ts, value in self.tsdb.latest(f"{metric}_bucket", self.matchers):
            le_raw = labels.get("le")
            if le_raw is None:
                continue
            le = float("inf") if le_raw in ("+Inf", "inf") else float(le_raw)
            per_le[le] = per_le.get(le, 0.0) + value
            newest = ts if newest is None else max(newest, ts)
        return per_le, newest

    def window(self, metric: str, q: float) -> _Window:
        per_le, newest = self._cumulative(metric)
        prev = self._prev.get(metric)
        if not per_le or newest is None:
            # nothing fresh in the TSDB: scrape gap, not idleness
            return _Window(None, 0, stale=True)
        self._prev[metric] = (per_le, newest)
        if prev is None:
            return _Window(None, 0, stale=True)  # first sight: no window yet
        prev_le, prev_ts = prev
        if newest <= prev_ts:
            # every series is frozen since last tick — the target set went
            # dark between scrapes; frozen counts must not quantile to
            # "no traffic"
            return _Window(None, 0, stale=True)
        deltas = {le: v - prev_le.get(le, 0.0) for le, v in per_le.items()}
        if any(d < 0 for d in deltas.values()) or float("inf") not in deltas:
            # counter reset (replica restart) — skip one window
            return _Window(None, 0, stale=True)
        finite = sorted(le for le in deltas if le != float("inf"))
        total = int(round(deltas[float("inf")]))
        if total <= 0:
            return _Window(None, 0)  # fresh data, zero traffic: genuine idle
        counts: List[int] = []
        prev_cum = 0.0
        for le in finite:
            counts.append(int(round(deltas[le] - prev_cum)))
            prev_cum = deltas[le]
        counts.append(int(round(deltas[float("inf")] - prev_cum)))
        return _Window(quantile_from_counts(tuple(finite), counts, total, q), total)


class SLOAutoscaler:
    """Drives ``fleet.scale_to`` from windowed SLO quantiles.

    ``tick()`` does one evaluation (tests and ``chip_smoke.py`` call it
    directly); ``start(interval)`` runs it on a timer thread and ``stop()``
    ends that thread. The fleet needs ``desired_replicas``,
    ``min_replicas``, ``max_replicas`` and ``scale_to(n, reason)``, and for
    pools ``pools``, ``pool_size(pool)`` and ``scale_to(n, reason, pool)``.
    """

    def __init__(self, fleet, config: Optional[AutoscalerConfig] = None,
                 registry=METRICS, source=None):
        self.fleet = fleet
        self.config = config or AutoscalerConfig()
        self._registry = registry
        self._source = source if source is not None else RegistryWindowSource(registry)
        #: per-pool hysteresis ("unified", or "prefill" and "decode", each
        #: with its own streaks and cooldown)
        self._pool_state: Dict[str, Dict[str, int]] = {}
        self._ticks = 0
        self._thread: Optional[threading.Thread] = None
        self._stop = threading.Event()
        #: the last tick's evaluation
        self.last: Dict = {}

    def _window(self, name: str) -> _Window:
        return self._source.window(name, self.config.quantile)

    def _evaluate(self, pool: str, windows: List[Tuple[_Window, float]],
                  size: int, lo: int, hi: int,
                  pass_pool: bool) -> Tuple[Optional[str], Dict]:
        """One pool's hysteresis step over its (window, SLO) pairs; scales
        the fleet and returns ``(decision, debug_state)``."""
        cfg = self.config
        st = self._pool_state.setdefault(pool, {"breach": 0, "idle": 0, "cooldown": 0})
        stale = any(w.stale for w, _ in windows)
        breach = (not stale
                  and any(w.value is not None and w.value > slo for w, slo in windows))
        idle = (not stale and not breach
                and all(w.value is None or w.value < cfg.scale_down_margin * slo
                        for w, slo in windows))
        if stale:
            st["breach"] = st["idle"] = 0  # staleness is not idleness: hold
        elif breach:
            st["breach"] += 1
            st["idle"] = 0
        elif idle:
            st["idle"] += 1
            st["breach"] = 0
        else:  # the band between margin * SLO and SLO: hold
            st["breach"] = st["idle"] = 0
        if st["cooldown"] > 0:
            st["cooldown"] -= 1

        decision: Optional[str] = None
        reason = ""
        if st["breach"] >= cfg.breach_ticks and st["cooldown"] == 0 and size < hi:
            reason = "slo_breach"
            decision = "up"
        elif st["idle"] >= cfg.idle_ticks and st["cooldown"] == 0 and size > lo:
            reason = "idle"
            decision = "down"
        if decision is not None:
            target = size + 1 if decision == "up" else size - 1
            if pass_pool:
                self.fleet.scale_to(target, reason=reason, pool=pool)
            else:
                self.fleet.scale_to(target, reason=reason)
            st["breach"] = st["idle"] = 0
            st["cooldown"] = cfg.cooldown_ticks
            METRICS.counter("fleet_autoscale_total", direction=decision,
                            reason=reason, pool=pool).inc()
        state = {"stale": stale, "breach_streak": st["breach"],
                 "idle_streak": st["idle"], "cooldown": st["cooldown"],
                 "decision": decision}
        return decision, state

    def tick(self) -> Optional[str]:
        """Evaluate one window; returns ``"up"``, ``"down"`` or None (with
        pools: the prefill decision if any, else decode's). A unified fleet
        scales on TTFT and queue wait; with pools, prefill scales on TTFT
        and decode on the inter-token gap."""
        cfg = self.config
        self._ticks += 1
        pools = getattr(self.fleet, "pools", None)
        if pools:
            ttft = self._window(TTFT_METRIC)
            itl = self._window(INTER_TOKEN_METRIC)
            dp, sp = self._evaluate("prefill", [(ttft, cfg.ttft_slo)],
                                    self.fleet.pool_size("prefill"), 1,
                                    self.fleet.max_replicas, pass_pool=True)
            dd, sd = self._evaluate("decode", [(itl, cfg.inter_token_slo)],
                                    self.fleet.pool_size("decode"), 1,
                                    self.fleet.max_replicas, pass_pool=True)
            decision = dp or dd
            self.last = {
                "tick": self._ticks, "source": self._source.name,
                "ttft_p": ttft.value, "ttft_samples": ttft.samples,
                "inter_token_p": itl.value, "inter_token_samples": itl.samples,
                "prefill": dict(sp, replicas=self.fleet.pool_size("prefill")),
                "decode": dict(sd, replicas=self.fleet.pool_size("decode")),
                "decision": decision,
            }
            return decision
        ttft = self._window(TTFT_METRIC)
        qwait = self._window(QUEUE_WAIT_METRIC)
        decision, st = self._evaluate(
            "unified", [(ttft, cfg.ttft_slo), (qwait, cfg.queue_wait_slo)],
            self.fleet.desired_replicas, self.fleet.min_replicas,
            self.fleet.max_replicas, pass_pool=False)
        self.last = {
            "tick": self._ticks, "source": self._source.name, "stale": st["stale"],
            "ttft_p": ttft.value, "ttft_samples": ttft.samples,
            "queue_wait_p": qwait.value, "queue_wait_samples": qwait.samples,
            "breach_streak": st["breach_streak"], "idle_streak": st["idle_streak"],
            "cooldown": st["cooldown"], "replicas": self.fleet.desired_replicas,
            "decision": decision,
        }
        return decision

    def start(self, interval: float = 5.0) -> None:
        if self._thread is not None:
            return

        def loop() -> None:
            while not self._stop.wait(interval):
                try:
                    self.tick()
                except Exception:  # the timer thread's boundary
                    # an autoscaler fault leaves the fleet at its size; it
                    # never takes the serving path down
                    LOG.exception("autoscaler tick failed")

        self._thread = threading.Thread(target=loop, name="slo-autoscaler", daemon=True)
        self._thread.start()

    def stop(self) -> None:
        self._stop.set()
        if self._thread is not None:
            self._thread.join(timeout=10)
            self._thread = None
