"""Strict OpenMetrics parser + the scrape loop feeding the TSDB: the
port's copy of ``kubeflow_tpu/monitoring/scrape.py``.

The parser accepts exactly the dialect ``MetricsRegistry.render()`` emits —
``# TYPE`` families, counter/gauge/histogram samples, OpenMetrics exemplar
suffixes on bucket lines, a terminating ``# EOF`` — and rejects everything
else with a line-numbered ``ParseError``. Parsed samples keep their raw
value/label/exemplar tokens so ``render_exposition`` round-trips the input
byte-faithfully. JAX's parser and this one accept and reject the same
texts, so either side's ``/metrics`` and ``/federate`` read on the other.

The ``Scraper`` pulls ``/metrics`` from a target set — a static list plus
live discovery of Pods carrying the ``monitoring.kubeflow.org/scrape``
annotations (JAX's annotation names; fleet replicas annotate themselves
via ``EngineFleet(metrics_url=...)``) through any client with
``list("v1", "Pod")`` — writes every sample into the TSDB with
``instance``/``job`` target labels, publishes per-target ``up`` and
``scrape_duration_seconds``, and marks a target's series stale after
``stale_after`` consecutive misses.
"""

from __future__ import annotations

import logging
import re
import threading
import time
import urllib.request
from dataclasses import dataclass, field
from typing import Dict, Iterable, List, Optional, Sequence, Tuple
from urllib.parse import urlparse

from ..runtime.metrics import METRICS, MetricsRegistry
from ..scheduler.gang import annotations_of, name_of
from .tsdb import TSDB

log = logging.getLogger("kubeflow_tpu_torch.monitoring")

#: Pod annotations driving scrape discovery (the prometheus.io/scrape idiom)
SCRAPE_ANNOTATION = "monitoring.kubeflow.org/scrape"
SCRAPE_URL_ANNOTATION = "monitoring.kubeflow.org/url"
SCRAPE_JOB_ANNOTATION = "monitoring.kubeflow.org/job"

_METRIC_KINDS = ("counter", "gauge", "histogram", "untyped")

_NAME_RE = re.compile(r"[a-zA-Z_:][a-zA-Z0-9_:]*")
_TYPE_RE = re.compile(
    r"^# TYPE ([a-zA-Z_:][a-zA-Z0-9_:]*) ([a-z]+)$"
)
_LABEL_PAIR_RE = re.compile(r'([a-zA-Z_][a-zA-Z0-9_]*)="((?:[^"\\]|\\.)*)"')
_EXEMPLAR_RE = re.compile(r"^\{(.*)\} (\S+) (\S+)$")


class ParseError(ValueError):
    def __init__(self, lineno: int, message: str):
        super().__init__(f"line {lineno}: {message}")
        self.lineno = lineno


def _unescape(value: str) -> str:
    return value.replace(r"\n", "\n").replace(r"\"", '"').replace("\\\\", "\\")


def _parse_labels(raw: str, lineno: int) -> Dict[str, str]:
    """Parse the inner text of ``{...}``; strict — the matched pairs joined
    by commas must reconstruct the raw text exactly, so stray tokens between
    pairs are an error rather than silently dropped."""
    if not raw:
        return {}
    pairs = list(_LABEL_PAIR_RE.finditer(raw))
    rebuilt = ",".join(m.group(0) for m in pairs)
    if rebuilt != raw.rstrip(","):
        raise ParseError(lineno, f"malformed label set {{{raw}}}")
    out: Dict[str, str] = {}
    for m in pairs:
        out[m.group(1)] = _unescape(m.group(2))
    return out


@dataclass
class Sample:
    """One exposition line, parsed and raw at once: ``labels``/``value`` are
    the semantic view; the ``raw_*`` tokens reproduce the input byte-for-byte
    (exemplar suffixes ride through ``raw_exemplar`` untouched)."""

    name: str
    labels: Dict[str, str]
    value: float
    raw_labels: str = ""
    raw_value: str = ""
    raw_exemplar: str = ""

    def render(self) -> str:
        labels = f"{{{self.raw_labels}}}" if self.raw_labels else ""
        value = self.raw_value or _format_value(self.value)
        return f"{self.name}{labels} {value}{self.raw_exemplar}"


@dataclass
class Family:
    name: str
    kind: str
    samples: List[Sample] = field(default_factory=list)

    def sample_names(self) -> Tuple[str, ...]:
        if self.kind == "histogram":
            return (f"{self.name}_bucket", f"{self.name}_sum",
                    f"{self.name}_count")
        return (self.name,)


def _format_value(v: float) -> str:
    return str(int(v)) if float(v).is_integer() and abs(v) < 1e15 else str(float(v))


def _scan_label_block(line: str, start: int, lineno: int) -> int:
    """Index just past the ``}`` closing the label block opened at ``start``
    (which must point at ``{``). Quote- and escape-aware."""
    i = start + 1
    in_quotes = False
    while i < len(line):
        c = line[i]
        if in_quotes:
            if c == "\\":
                i += 1
            elif c == '"':
                in_quotes = False
        elif c == '"':
            in_quotes = True
        elif c == "}":
            return i + 1
        i += 1
    raise ParseError(lineno, "unterminated label set")


def _parse_sample_line(line: str, lineno: int) -> Sample:
    m = _NAME_RE.match(line)
    if not m:
        raise ParseError(lineno, f"expected metric name: {line!r}")
    name = m.group(0)
    idx = m.end()
    raw_labels = ""
    if idx < len(line) and line[idx] == "{":
        end = _scan_label_block(line, idx, lineno)
        raw_labels = line[idx + 1:end - 1]
        idx = end
    rest = line[idx:]
    if not rest.startswith(" "):
        raise ParseError(lineno, f"expected value after name/labels: {line!r}")
    rest = rest[1:]
    raw_exemplar = ""
    if " # " in rest:
        value_tok, exemplar = rest.split(" # ", 1)
        if not _EXEMPLAR_RE.match(exemplar):
            raise ParseError(lineno, f"malformed exemplar: {exemplar!r}")
        raw_exemplar = f" # {exemplar}"
    else:
        value_tok = rest
    value_tok = value_tok.strip()
    if not value_tok or " " in value_tok:
        raise ParseError(lineno, f"expected a single value token: {rest!r}")
    try:
        value = float(value_tok)
    except ValueError:
        raise ParseError(lineno, f"bad value {value_tok!r}") from None
    return Sample(
        name=name,
        labels=_parse_labels(raw_labels, lineno),
        value=value,
        raw_labels=raw_labels,
        raw_value=value_tok,
        raw_exemplar=raw_exemplar,
    )


def parse_exposition(text: str, require_eof: bool = True) -> List[Family]:
    """Parse one exposition document into ordered families. Strict: every
    sample must belong to the most recently declared ``# TYPE`` family,
    ``# EOF`` must terminate the document (and nothing may follow it), and
    any line that is neither a comment nor a well-formed sample raises."""
    if text and not text.endswith("\n"):
        raise ParseError(text.count("\n") + 1, "exposition must end with a newline")
    families: List[Family] = []
    by_name: Dict[str, Family] = {}
    current: Optional[Family] = None
    saw_eof = False
    for lineno, line in enumerate(text.split("\n")[:-1], start=1):
        if saw_eof:
            raise ParseError(lineno, "content after # EOF")
        if not line.strip():
            continue
        if line.startswith("#"):
            if line == "# EOF":
                saw_eof = True
                continue
            if line.startswith("# HELP "):
                continue
            tm = _TYPE_RE.match(line)
            if not tm:
                raise ParseError(lineno, f"malformed comment line: {line!r}")
            name, kind = tm.group(1), tm.group(2)
            if kind not in _METRIC_KINDS:
                raise ParseError(lineno, f"unknown metric kind {kind!r}")
            if name in by_name:
                raise ParseError(lineno, f"duplicate # TYPE for {name}")
            current = Family(name=name, kind=kind)
            by_name[name] = current
            families.append(current)
            continue
        sample = _parse_sample_line(line, lineno)
        if current is None:
            raise ParseError(lineno, f"sample {sample.name} before any # TYPE")
        if sample.name not in current.sample_names():
            raise ParseError(
                lineno,
                f"sample {sample.name} does not belong to family "
                f"{current.name} ({current.kind})",
            )
        if sample.raw_exemplar and current.kind not in ("histogram", "counter"):
            raise ParseError(lineno, f"exemplar on a {current.kind} sample")
        current.samples.append(sample)
    if require_eof and not saw_eof:
        raise ParseError(text.count("\n") + 1, "missing # EOF terminator")
    return families


def render_exposition(families: Iterable[Family]) -> str:
    """Re-expose parsed families; with untouched ``raw_*`` tokens the output
    is byte-identical to the parsed input (the round-trip contract)."""
    lines: List[str] = []
    for fam in families:
        lines.append(f"# TYPE {fam.name} {fam.kind}")
        for s in fam.samples:
            lines.append(s.render())
    lines.append("# EOF")
    return "\n".join(lines) + "\n"


# -- targets + scraper --------------------------------------------------------


@dataclass(frozen=True)
class Target:
    job: str
    url: str

    @property
    def instance(self) -> str:
        return urlparse(self.url).netloc or self.url


class Scraper:
    """Pull-based collection: static targets + annotated-Pod discovery,
    deduplicated by instance (two Pods advertising one URL — e.g. fleet
    replicas sharing a ModelServer — federate as ONE instance, not a
    double-counted pair)."""

    def __init__(
        self,
        tsdb: TSDB,
        targets: Sequence[Target] = (),
        client=None,
        timeout_s: float = 5.0,
        stale_after: int = 3,
        registry: MetricsRegistry = METRICS,
    ) -> None:
        self.tsdb = tsdb
        self._static = list(targets)
        self._client = client
        self._timeout_s = timeout_s
        self.stale_after = int(stale_after)
        self._registry = registry
        self._misses: Dict[str, int] = {}
        self._stop = threading.Event()
        self._thread: Optional[threading.Thread] = None
        self._lock = threading.Lock()

    def add_target(self, target: Target) -> None:
        with self._lock:
            self._static.append(target)

    def discover(self) -> List[Target]:
        """Static targets plus every Pod annotated for scraping, first
        writer per instance wins (static list outranks discovery)."""
        with self._lock:
            targets: Dict[str, Target] = {t.instance: t for t in self._static}
        if self._client is not None:
            try:
                pods = self._client.list("v1", "Pod")
            except Exception:
                log.exception("scrape discovery: Pod list failed")
                pods = []
            for pod in pods:
                ann = annotations_of(pod)
                if ann.get(SCRAPE_ANNOTATION) != "true":
                    continue
                url = ann.get(SCRAPE_URL_ANNOTATION)
                if not url:
                    continue
                t = Target(job=ann.get(SCRAPE_JOB_ANNOTATION) or name_of(pod),
                           url=url)
                targets.setdefault(t.instance, t)
        return list(targets.values())

    def fetch(self, target: Target) -> str:
        with urllib.request.urlopen(target.url, timeout=self._timeout_s) as resp:
            if resp.status != 200:
                raise IOError(f"{target.url}: HTTP {resp.status}")
            return resp.read().decode("utf-8")

    def scrape_once(self, now: Optional[float] = None) -> Dict[str, bool]:
        """One pass over the discovered target set; returns instance → up.
        Every attempt — success or not — lands ``up`` and
        ``scrape_duration_seconds`` in the TSDB so rules can alert on
        absence, not just on badness."""
        now = time.time() if now is None else now
        targets = self.discover()
        self._registry.gauge("monitoring_scrape_targets").set(float(len(targets)))
        results: Dict[str, bool] = {}
        for target in targets:
            results[target.instance] = self._scrape_target(target, now)
        return results

    def _scrape_target(self, target: Target, now: float) -> bool:
        start = time.perf_counter()
        try:
            families = parse_exposition(self.fetch(target))
        except Exception as e:
            duration = time.perf_counter() - start
            misses = self._misses.get(target.instance, 0) + 1
            self._misses[target.instance] = misses
            if misses >= self.stale_after:
                flipped = self.tsdb.mark_stale(instance=target.instance)
                if flipped:
                    log.warning("target %s stale after %d misses (%d series): %s",
                                target.instance, misses, flipped, e)
            self._registry.counter("monitoring_scrapes_total", result="error").inc()
            self._write_target_health(target, up=0.0, duration=duration, now=now)
            return False
        duration = time.perf_counter() - start
        self._misses[target.instance] = 0
        self._ingest(target, families, now)
        self._registry.counter("monitoring_scrapes_total", result="ok").inc()
        self._write_target_health(target, up=1.0, duration=duration, now=now)
        return True

    def _write_target_health(self, target: Target, up: float, duration: float,
                             now: float) -> None:
        labels = {"instance": target.instance, "job": target.job}
        self.tsdb.set_kind("up", "gauge")
        self.tsdb.set_kind("scrape_duration_seconds", "gauge")
        self.tsdb.add_sample("up", labels, now, up)
        self.tsdb.add_sample("scrape_duration_seconds", labels, now, duration)

    def _ingest(self, target: Target, families: List[Family], now: float) -> None:
        for fam in families:
            self.tsdb.set_kind(fam.name, fam.kind, fam.sample_names())
            for s in fam.samples:
                labels = dict(s.labels)
                # honor_labels=false: a scraped series may not impersonate
                # another target — its own instance/job move aside
                for reserved in ("instance", "job"):
                    if reserved in labels:
                        labels[f"exported_{reserved}"] = labels.pop(reserved)
                labels["instance"] = target.instance
                labels["job"] = target.job
                self.tsdb.add_sample(s.name, labels, now, s.value)

    # -- background loop -----------------------------------------------------
    def start(self, interval_s: float) -> None:
        if self._thread is not None:
            return
        self._stop.clear()

        def loop() -> None:
            while not self._stop.is_set():
                try:
                    self.scrape_once()
                except Exception:
                    log.exception("scrape pass failed")
                self._stop.wait(interval_s)

        self._thread = threading.Thread(target=loop, name="monitoring-scraper",
                                        daemon=True)
        self._thread.start()

    def stop(self) -> None:
        self._stop.set()
        if self._thread is not None:
            self._thread.join(timeout=5.0)
            self._thread = None
