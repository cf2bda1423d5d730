"""Recording rules and multi-window multi-burn-rate SLO alerts: the port's
copy of ``kubeflow_tpu/monitoring/rules.py``.

The alert shape is the SRE-workbook recipe: for an objective like "99% of
requests under 250ms", the error budget is 1% and the *burn rate* is
(bad fraction)/(budget). An alert pair fires when the burn rate exceeds a
factor in BOTH a short and a long window — the short window gives fast
detection and fast reset, the long window gives resistance to blips. The
default pairs are the workbook's page (5m/1h, 14.4×) and ticket (30m/6h,
6×) tiers.

Lifecycle per pair: inactive → pending (condition holds, ``for_s`` not yet
served) → firing → resolved. Firing alerts surface three ways: the
``alerts_firing{alertname,severity}`` gauge, ``/debug/alerts`` (via
``obs.register_debug_source``, wired by plane.py), and — when a client is
attached — K8s Warning Events through the client's ``events`` (an
``EventRecorder``, ``runtime/events.py``), which deduplicates repeat
emissions into ONE Event with a bumped count.

"No data" is never "no errors": the bad fraction is ``None`` when a window
saw no traffic, and a None on either window holds the alert's current
state rather than resolving it — a scrape gap must not silently close a
page.
"""

from __future__ import annotations

import logging
import time
from dataclasses import dataclass
from typing import Callable, Dict, Iterable, List, Optional, Sequence, Tuple

from ..runtime.metrics import METRICS, MetricsRegistry
from .tsdb import TSDB, Matchers

log = logging.getLogger("kubeflow_tpu_torch.monitoring")


@dataclass(frozen=True)
class BurnRateWindow:
    short_s: float
    long_s: float
    factor: float
    severity: str


#: SRE-workbook multi-window multi-burn-rate defaults: a 14.4× burn exhausts
#: a 30-day budget in ~2 days (page), a 6× burn in ~5 days (ticket)
DEFAULT_BURN_RATE_WINDOWS: Tuple[BurnRateWindow, ...] = (
    BurnRateWindow(short_s=300.0, long_s=3600.0, factor=14.4, severity="page"),
    BurnRateWindow(short_s=1800.0, long_s=21600.0, factor=6.0, severity="ticket"),
)


@dataclass
class RecordingRule:
    """Evaluate ``fn(tsdb, now) -> iterable of (labels, value)`` each tick
    and write the results back as gauge series named ``record`` — the
    precompute-once pattern for anything a dashboard polls."""

    record: str
    fn: Callable[[TSDB, float], Iterable[Tuple[Dict[str, str], float]]]


@dataclass
class _PairState:
    state: str = "inactive"  # inactive | pending | firing | resolved
    pending_since: Optional[float] = None
    firing_since: Optional[float] = None
    resolved_at: Optional[float] = None
    burn_short: Optional[float] = None
    burn_long: Optional[float] = None


class SLOBurnRateAlert:
    """Latency-SLO burn-rate alert over one histogram family.

    ``objective`` is the good fraction (0.99 → 1% budget); a request is bad
    when it lands above ``threshold_s`` — which should align with a bucket
    bound of the histogram, since bucket resolution is all the exposition
    gives us. ``matchers`` scope the series (e.g. ``{"job": "serving"}``).
    """

    def __init__(
        self,
        name: str,
        metric: str,
        threshold_s: float,
        objective: float = 0.99,
        windows: Sequence[BurnRateWindow] = DEFAULT_BURN_RATE_WINDOWS,
        matchers: Optional[Matchers] = None,
        for_s: float = 0.0,
        involved: Optional[dict] = None,
    ) -> None:
        if not 0.0 < objective < 1.0:
            raise ValueError(f"objective {objective} outside (0, 1)")
        self.name = name
        self.metric = metric
        self.threshold_s = float(threshold_s)
        self.objective = float(objective)
        self.budget = 1.0 - self.objective
        self.windows = tuple(windows)
        self.matchers = matchers
        self.for_s = float(for_s)
        self.involved = involved
        self._pairs: Dict[str, _PairState] = {
            w.severity: _PairState() for w in self.windows
        }

    def bad_fraction(self, tsdb: TSDB, window_s: float, now: float) -> Optional[float]:
        """Fraction of observations above the threshold in the window, or
        None when the window carried no traffic (no data ≠ no errors)."""
        snap = tsdb.windowed_bucket_counts(self.metric, window_s, now, self.matchers)
        if snap is None:
            return None
        buckets, counts, total = snap
        good = 0
        for bound, count in zip(buckets, counts):
            if bound <= self.threshold_s + 1e-12:
                good += count
        return max(0.0, (total - good) / total)

    def evaluate(self, tsdb: TSDB, now: float) -> List[dict]:
        """Advance every window pair's state machine; returns one status
        dict per pair, flagging ``fired``/``resolved`` transitions so the
        engine knows when to emit Events."""
        statuses: List[dict] = []
        for w in self.windows:
            st = self._pairs[w.severity]
            burn_short = self._burn(tsdb, w.short_s, now)
            burn_long = self._burn(tsdb, w.long_s, now)
            st.burn_short, st.burn_long = burn_short, burn_long
            fired = resolved = False
            if burn_short is None or burn_long is None:
                # scrape gap / no traffic: hold state, never auto-resolve
                pass
            elif burn_short > w.factor and burn_long > w.factor:
                if st.state in ("inactive", "resolved"):
                    st.state = "pending"
                    st.pending_since = now
                if st.state == "pending" and now - (st.pending_since or now) >= self.for_s:
                    st.state = "firing"
                    st.firing_since = now
                    fired = True
            else:
                if st.state == "firing":
                    st.state = "resolved"
                    st.resolved_at = now
                    resolved = True
                elif st.state == "pending":
                    st.state = "inactive"
                    st.pending_since = None
            statuses.append({
                "alertname": self.name,
                "severity": w.severity,
                "state": st.state,
                "metric": self.metric,
                "threshold_s": self.threshold_s,
                "objective": self.objective,
                "factor": w.factor,
                "windows_s": [w.short_s, w.long_s],
                "burn_short": burn_short,
                "burn_long": burn_long,
                "since": st.firing_since if st.state == "firing" else st.pending_since,
                "fired": fired,
                "resolved": resolved,
            })
        return statuses

    def _burn(self, tsdb: TSDB, window_s: float, now: float) -> Optional[float]:
        frac = self.bad_fraction(tsdb, window_s, now)
        return None if frac is None else frac / self.budget


class RuleEngine:
    """Evaluate recording rules then alerts against one TSDB, publishing
    eval latency (``monitoring_rule_eval_seconds``), the per-alert
    ``alerts_firing`` gauge, and — with a client — K8s Events. Re-emitting
    the same Warning while an alert stays firing is intentional: the
    EventRecorder's dedup turns the stream into one Event with a rising
    ``count``, which is exactly the operator-facing contract."""

    def __init__(self, tsdb: TSDB, client=None,
                 registry: MetricsRegistry = METRICS,
                 component: str = "slo-monitor",
                 repeat_s: float = 30.0) -> None:
        self.tsdb = tsdb
        self._client = client
        self._registry = registry
        self._component = component
        #: minimum seconds between repeated firing Events for one alert
        #: (Alertmanager's repeat_interval). Emitting on EVERY eval would
        #: drain the EventRecorder's spam-filter tokens and starve the
        #: resolve notification.
        self.repeat_s = repeat_s
        self._last_emit: Dict[Tuple[str, str], float] = {}
        self.recording_rules: List[RecordingRule] = []
        self.alerts: List[SLOBurnRateAlert] = []
        self.last_statuses: List[dict] = []
        self.evaluations = 0

    def add(self, rule) -> None:
        if isinstance(rule, RecordingRule):
            self.recording_rules.append(rule)
        elif isinstance(rule, SLOBurnRateAlert):
            self.alerts.append(rule)
        else:
            raise TypeError(f"not a rule: {rule!r}")

    def evaluate(self, now: Optional[float] = None) -> List[dict]:
        now = time.time() if now is None else now
        with self._registry.timer("monitoring_rule_eval_seconds"):
            for rule in self.recording_rules:
                try:
                    self.tsdb.set_kind(rule.record, "gauge")
                    for labels, value in rule.fn(self.tsdb, now):
                        self.tsdb.add_sample(rule.record, labels, now, value)
                except Exception:
                    log.exception("recording rule %s failed", rule.record)
                    self._registry.counter(
                        "monitoring_rule_failures_total", record=rule.record
                    ).inc()
            statuses: List[dict] = []
            for alert in self.alerts:
                statuses.extend(alert.evaluate(self.tsdb, now))
            for s in statuses:
                self._publish(s, now)
        self.last_statuses = statuses
        self.evaluations += 1
        return statuses

    def _publish(self, status: dict, now: float) -> None:
        firing = status["state"] == "firing"
        self._registry.gauge(
            "alerts_firing",
            alertname=status["alertname"],
            severity=status["severity"],
        ).set(1.0 if firing else 0.0)
        if self._client is None:
            return
        key = (status["alertname"], status["severity"])
        if firing:
            last = self._last_emit.get(key)
            if last is not None and now - last < self.repeat_s:
                return  # within the repeat interval: the Event already says it
            self._last_emit[key] = now
        elif status["resolved"]:
            self._last_emit.pop(key, None)
        involved = self._involved(status)
        recorder = self._client.events
        if firing:
            recorder.emit(
                involved,
                reason=status["alertname"],
                message=(
                    f"SLO burn-rate alert {status['alertname']} "
                    f"({status['severity']}) firing: burn "
                    f"{_fmt_burn(status['burn_short'])}x/"
                    f"{_fmt_burn(status['burn_long'])}x over "
                    f"{int(status['windows_s'][0])}s/{int(status['windows_s'][1])}s "
                    f"windows exceeds {status['factor']}x "
                    f"(objective {status['objective']}, "
                    f"threshold {status['threshold_s']}s on {status['metric']})"
                ),
                type_="Warning",
                component=self._component,
            )
        elif status["resolved"]:
            recorder.emit(
                involved,
                reason=f"{status['alertname']}Resolved",
                message=(
                    f"SLO burn-rate alert {status['alertname']} "
                    f"({status['severity']}) resolved"
                ),
                type_="Normal",
                component=self._component,
            )

    def _involved(self, status: dict) -> dict:
        for alert in self.alerts:
            if alert.name == status["alertname"] and alert.involved is not None:
                return alert.involved
        return {
            "apiVersion": "v1",
            "kind": "Service",
            "metadata": {"name": status["alertname"].lower(),
                         "namespace": "kubeflow-system"},
        }

    def snapshot(self) -> dict:
        """The ``/debug/alerts`` payload."""
        return {
            "evaluations": self.evaluations,
            "alerts": [
                {k: v for k, v in s.items() if k not in ("fired", "resolved")}
                for s in self.last_statuses
            ],
            "recording_rules": [r.record for r in self.recording_rules],
        }


def _fmt_burn(burn: Optional[float]) -> str:
    return "?" if burn is None else f"{burn:.1f}"
