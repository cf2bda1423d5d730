"""Training of the port: the GPT and ResNet-50 train steps of the JAX
package's bench (``training/gpt.py``, ``training/resnet.py``,
``training/classifier.py``, on a mesh too), draft distillation for
speculative decoding (``training/distill.py``), crash-safe checkpoints in
the JAX package's format (``training/checkpoint.py``), elastic training
through preemptions (``training/elastic.py``) with per-worker step beacons
(``training/heartbeat.py``), MFU accounting (``training/flops.py``),
per-module cost attribution (``training/attribution.py``) and the
bench-in-the-loop autotuner (``training/autotune.py``)."""

from .attribution import (  # noqa: F401
    AttributionReport,
    ModuleCost,
    attribute_gpt,
    attribute_resnet,
    attribution_report,
    price_callable,
    record_step_peak_hbm,
)
from .autotune import (  # noqa: F401
    AutotuneResult,
    TunedCandidate,
    autotune_gpt_quick,
    autotune_resnet_quick,
    measure_steps,
    sweep,
)
from .flops import memory_stats, mfu, peak_hbm_bandwidth  # noqa: F401
