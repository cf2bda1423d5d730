"""The port's accelerator seam: the GPU catalog (``topology.py``) and step
telemetry with its ``/debug/profile`` endpoint and profile server
(``profiling.py``), the counterparts of ``kubeflow_tpu/tpu/``."""
