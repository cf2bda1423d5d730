"""What the serving drivers share: an HTTP client for the model server, a
poll, an exposition reader, a retry loop and the JUnit report.

Copies of the JAX side's helpers (``e2e/overload_driver.py``'s ``_get``,
``_post``, ``_poll`` and ``_metric_value``, ``e2e/cluster.py``'s
``http_json``, ``e2e/retry.py``'s ``run_with_retry`` and
``e2e/junit.py``'s ``run_driver``), one copy for every driver of the port.
"""

from __future__ import annotations

import argparse
import json
import logging
import time
import urllib.error
import urllib.request
from typing import Any, Callable, Dict, List, Optional, Tuple, Type, TypeVar
from xml.sax.saxutils import escape, quoteattr

LOG = logging.getLogger(__name__)

T = TypeVar("T")


def get(url: str) -> bytes:
    with urllib.request.urlopen(url, timeout=60) as resp:
        return resp.read()


def post(url: str, body: dict, headers: Optional[Dict[str, str]] = None,
         timeout: float = 120.0) -> Tuple[int, Dict[str, str], Any]:
    """POST JSON, returning ``(status, headers, parsed_body)``: 4xx/5xx are
    observations here, not exceptions."""
    hdrs = {"content-type": "application/json"}
    hdrs.update(headers or {})
    req = urllib.request.Request(url, json.dumps(body).encode(), hdrs)
    try:
        with urllib.request.urlopen(req, timeout=timeout) as resp:
            return resp.status, dict(resp.headers), json.loads(resp.read())
    except urllib.error.HTTPError as e:
        raw = e.read()
        try:
            parsed = json.loads(raw)
        except ValueError:
            parsed = {"raw": raw.decode(errors="replace")}
        return e.code, dict(e.headers), parsed


def poll(fn: Callable[[], T], timeout: float = 30.0, interval: float = 0.02,
         desc: str = "condition") -> T:
    """``fn()``'s first truthy value within ``timeout`` seconds; an
    AssertionError after."""
    deadline = time.monotonic() + timeout
    while time.monotonic() < deadline:
        value = fn()
        if value:
            return value
        time.sleep(interval)
    raise AssertionError(f"timed out after {timeout}s waiting for {desc}")


def metric_value(text: str, name: str, **labels: str) -> float:
    """The sum of every sample of ``name`` whose labels include ``labels``
    in an exposition text (exemplars ignored)."""
    total = 0.0
    for line in text.splitlines():
        if not line.startswith(name):
            continue
        rest = line[len(name):]
        if rest[:1] not in ("{", " "):
            continue
        if all(f'{k}="{v}"' in rest for k, v in labels.items()):
            total += float(line.split(" # ")[0].rsplit(" ", 1)[1])
    return total


def http_json(method: str, url: str, body: Optional[Dict[str, Any]] = None) -> Dict[str, Any]:
    """One JSON request; an HTTP error raises (``urllib.error.HTTPError``)."""
    data = json.dumps(body).encode() if body is not None else None
    req = urllib.request.Request(url, data=data, method=method)
    req.add_header("content-type", "application/json")
    with urllib.request.urlopen(req, timeout=10) as resp:
        payload = resp.read()
    return json.loads(payload) if payload else {}


def run_with_retry(fn: Callable[[], T], retries: int = 10, delay: float = 0.5,
                   retry_on: Tuple[Type[BaseException], ...] = (Exception,)) -> T:
    """``fn()``, tried up to ``retries`` times ``delay`` seconds apart on
    ``retry_on``; the last error re-raised."""
    last: BaseException = RuntimeError("run_with_retry: zero attempts")
    for attempt in range(retries):
        try:
            return fn()
        except retry_on as e:
            last = e
            LOG.debug("attempt %d/%d failed: %s", attempt + 1, retries, e)
            if attempt < retries - 1:
                time.sleep(delay)
    raise last


def junit_xml(suite_name: str, class_name: str, name: str, seconds: float,
              failure: Optional[str]) -> str:
    """A JUnit report of one case (``failure`` None: it passed)."""
    case = (f"  <testcase classname={quoteattr(class_name)} name={quoteattr(name)} "
            f"time=\"{seconds:.3f}\"")
    case += (f">\n    <failure>{escape(failure)}</failure>\n  </testcase>" if failure
             else "/>")
    return ('<?xml version="1.0" encoding="utf-8"?>\n'
            f"<testsuite name={quoteattr(suite_name)} tests=\"1\" "
            f"failures=\"{int(failure is not None)}\">\n{case}\n</testsuite>\n")


def run_driver(suite_name: str, class_name: str, case_name: str,
               make_case: Callable[[argparse.Namespace], Callable[[], Any]],
               argv: Optional[List[str]] = None,
               add_args: Optional[Callable[[argparse.ArgumentParser], None]] = None,
               default_junit: str = "junit.xml") -> int:
    """A driver's command line: ``--junit`` (and ``add_args``' flags), the
    flow ``make_case(args)`` run as one JUnit case, the XML written, PASS or
    FAIL printed; the exit code."""
    parser = argparse.ArgumentParser()
    if add_args is not None:
        add_args(parser)
    parser.add_argument("--junit", default=default_junit)
    args = parser.parse_args(argv)

    flow = make_case(args)
    t0 = time.perf_counter()
    failure = None
    try:
        flow()
    except Exception as e:  # reported in the XML and the exit code, not raised
        failure = f"{type(e).__name__}: {e}"
    seconds = time.perf_counter() - t0
    with open(args.junit, "w") as f:
        f.write(junit_xml(suite_name, class_name, case_name, seconds, failure))
    print(("PASS" if failure is None else f"FAIL: {failure}") + f" ({seconds:.1f}s)")
    return 0 if failure is None else 1
