"""The port's accelerator seam: the GPU catalog (``topology.py``) and step
telemetry (``profiling.py``), the counterparts of ``kubeflow_tpu/tpu/``."""
