"""Runtime support for the port: metrics registry and tracing (trimmed
copies of ``kubeflow_tpu.runtime``'s, no JAX anywhere)."""
