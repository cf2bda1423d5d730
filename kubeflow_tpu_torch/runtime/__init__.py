"""Runtime support for the port: metrics registry, tracing, the
observability routes, the Event recorder and the serving chaos (trimmed
copies of ``kubeflow_tpu.runtime``'s, no JAX anywhere)."""
