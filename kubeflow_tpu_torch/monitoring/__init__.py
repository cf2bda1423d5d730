"""The port's training-side monitoring: trimmed copies of
``kubeflow_tpu/monitoring/goodput.py`` (the goodput ledger, ``goodput``)
and ``kubeflow_tpu/monitoring/stragglers.py`` (the straggler and hang
detector, ``stragglers``). The JAX package's monitoring plane (scrapes,
TSDB, rules, dashboards) is control plane and not ported."""
