"""Input pipeline of the port: host-side prefetch and device double
buffering (the port of ``kubeflow_tpu.data``)."""

from .pipeline import (DataPipeline, device_prefetch, per_host_shard,  # noqa: F401
                       synthetic_classifier_source)
