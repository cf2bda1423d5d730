"""The port's API machinery (trimmed copies of ``kubeflow_tpu/api/``):
``meta`` (object helpers, the kind registry, label selectors) and
``conversion`` (hub-and-spoke versions)."""
