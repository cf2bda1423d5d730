"""Runtime support for the port: metrics registry, tracing and the
observability routes (trimmed copies of ``kubeflow_tpu.runtime``'s, no JAX
anywhere)."""
