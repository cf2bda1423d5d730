"""The port's monitoring: trimmed copies of ``kubeflow_tpu/monitoring/``.

- ``tsdb``, ``scrape``, ``rules``, ``plane`` and ``traces`` — the monitoring
  plane: a bounded TSDB, the strict OpenMetrics parser and the scraper
  (static targets and Pods annotated for scraping), recording rules and
  SLO burn-rate alerts written as deduplicated Events, ``MonitoringPlane``
  with ``/federate`` and ``/debug/alerts``, and the trace collector;
- ``goodput`` — the goodput ledger, the tenant chip meter and the goodput
  recording rule;
- ``stragglers`` — the straggler and hang detector and its rules.
"""
