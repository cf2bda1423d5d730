"""Serving path of the port: the continuous-batching engine (speculative
decoding, prefill/decode roles), its paged KV allocator, the KV wire format
and error taxonomy, the model server, and the fleet (replicas behind a
prefix-aware router, scaled by an SLO autoscaler)."""

from .autoscaler import AutoscalerConfig, RegistryWindowSource, SLOAutoscaler  # noqa: F401
from .continuous import ContinuousBatcher  # noqa: F401
from .errors import FleetSaturated  # noqa: F401
from .fleet import EngineFleet, ReplicaBreaker, RetryBudget  # noqa: F401
from .router import PrefixRouter  # noqa: F401
from .server import GenerativeModel, ModelServer, ServedModel  # noqa: F401
