"""HTTP surface of the port (a trimmed copy of ``kubeflow_tpu.web.http``)."""
