"""The port's accelerator seam: the GPU catalog and node topology
(``topology.py``), the torchrun worker environment (``env.py``) and step
telemetry with its ``/debug/profile`` endpoint and profile server
(``profiling.py``), the counterparts of ``kubeflow_tpu/tpu/``."""
