"""Analytic per-axis communication model for the composed 4D train step.

The port of ``kubeflow_tpu/parallel/comm.py``: the same arithmetic (held
to JAX's to 1e-12 by ``tests/test_torch_parallel.py``), read from the
port's :class:`~kubeflow_tpu_torch.parallel.mesh.Mesh` (``mesh.shape``)
and ``CompositeConfig``. It estimates per-device bytes moved over each
mesh axis per step from the specs and the schedule shape, not from the
interconnect.

Ring-collective cost model (bytes on the wire per participating device,
buffer of B bytes over an axis of k devices):

    all_gather / reduce_scatter : (k-1)/k * B      (B = gathered size)
    all_reduce                  : 2*(k-1)/k * B    (reduce-scatter + gather)
    ppermute                    : B                (one neighbor hop)

Backward costs mirror forward, so fwd+bwd is 2x the forward count.
"""

from __future__ import annotations

from typing import Dict

from .composite import CompositeConfig
from .mesh import AXIS_DATA, AXIS_FSDP, AXIS_MODEL, AXIS_PIPE, Mesh
from .pipeline import schedule_stats


def ring_allgather_bytes(buffer_bytes: float, axis_size: int) -> float:
    """Per-device wire bytes to all_gather (or reduce_scatter) a buffer of
    ``buffer_bytes`` GATHERED size over ``axis_size`` ring devices."""
    if axis_size <= 1:
        return 0.0
    return (axis_size - 1) / axis_size * buffer_bytes


def ring_allreduce_bytes(buffer_bytes: float, axis_size: int) -> float:
    """Per-device wire bytes for a ring all_reduce (psum) of ``buffer_bytes``."""
    return 2.0 * ring_allgather_bytes(buffer_bytes, axis_size)


def composite_param_count(cfg: CompositeConfig) -> int:
    """Logical (unsharded) parameter count of the composite GPT."""
    d, ff, nl = cfg.d_model, cfg.d_ff, cfg.n_layers
    per_layer = 3 * d * d + d * d + 2 * d * ff + 2 * d  # qkv + wo + mlp + lns
    return nl * per_layer + cfg.vocab_size * d


def composite_step_flops(cfg: CompositeConfig, tokens: int) -> float:
    """Estimated fwd+bwd FLOPs for one step over ``tokens`` tokens: the
    standard 6*N approximation plus the quadratic attention term."""
    n = composite_param_count(cfg)
    attn = 12 * cfg.n_layers * cfg.d_model * cfg.seq  # per token, fwd+bwd
    return float(tokens) * (6.0 * n + attn)


def composite_comm_bytes(
    cfg: CompositeConfig,
    mesh: Mesh,
    num_micro: int,
    microbatch: int,
    *,
    virtual_stages: int = 1,
    gather_mode: str = "eager",
    dtype_bytes: int = 4,
) -> Dict[str, float]:
    """Estimated per-device bytes per train step (fwd+bwd), keyed by mesh
    axis, for the composite GPT under the given schedule and gather mode.

    ``microbatch`` is the GLOBAL microbatch size (the bench's ``mb``); the
    per-device activation slice divides it by the batch axes.
    """
    dp = mesh.shape.get(AXIS_DATA, 1)
    fs = mesh.shape.get(AXIS_FSDP, 1)
    tp = mesh.shape.get(AXIS_MODEL, 1)
    pp = mesh.shape.get(AXIS_PIPE, 1)
    d, ff, nl = cfg.d_model, cfg.d_ff, cfg.n_layers
    lpc = nl // (pp * virtual_stages)  # layers per stage chunk
    mb_local = max(1, microbatch // (dp * fs))
    act_bytes = mb_local * cfg.seq * d * dtype_bytes

    stats = schedule_stats(num_micro, pp, virtual_stages)
    total_steps = int(stats["total_steps"])
    compute_steps = int(stats["compute_steps"])  # = V * M

    # pipe: one activation ppermute per scan step, fwd + transposed bwd.
    pipe = 2.0 * total_steps * act_bytes if pp > 1 else 0.0

    # fsdp: tiled all_gathers of the tp-local layer weights, transposing to
    # reduce_scatters in bwd. Call count depends on the gather mode:
    #   eager     — lpc layer-gathers per stage invocation, V*M invocations
    #   overlap   — same + one discarded clamped prefetch per invocation
    #   amortized — ALL V*lpc chunk layers once per step (stage_prepare)
    layer_w_bytes = (3 * d * d + d * d + 2 * d * ff) // tp * dtype_bytes
    if gather_mode == "amortized":
        layer_gathers = virtual_stages * lpc
    elif gather_mode == "overlap":
        layer_gathers = compute_steps * (lpc + 1)
    else:
        layer_gathers = compute_steps * lpc
    fsdp = 2.0 * layer_gathers * ring_allgather_bytes(layer_w_bytes, fs)

    # model: two psums of the activation per block (attn-out, mlp-out),
    # mirrored in bwd; blocks executed = compute_steps * lpc.
    model = (
        2.0 * compute_steps * lpc * 2.0 * ring_allreduce_bytes(act_bytes, tp)
    )

    # data: gradient all-reduce of the locally-held param shard over the
    # data axis (fsdp grads arrive pre-scattered via the transposed
    # gathers); the replicated-over-(data,fsdp) embed reduces over both.
    chunk_layers = virtual_stages * lpc  # layers resident per device
    stage_shard_bytes = (
        chunk_layers * (layer_w_bytes // max(1, fs) + 2 * d * dtype_bytes)
    )
    embed_bytes = cfg.vocab_size * d // tp * dtype_bytes
    data = ring_allreduce_bytes(stage_shard_bytes, dp) + ring_allreduce_bytes(
        embed_bytes, dp * fs
    )

    out = {"pipe": pipe, "fsdp": fsdp, "model": model, "data": data}
    out["total"] = sum(out.values())
    return out


def collective_wait_seconds(
    total_bytes: float, *, link_bandwidth_gbps: float = 100.0
) -> float:
    """Analytic lower bound on a step's collective-wait wall time: the
    modeled per-device wire bytes (``composite_comm_bytes(...)["total"]``)
    pushed over one link at ``link_bandwidth_gbps`` (JAX's default).

    The straggler plane's beacons use it as the *expected* collective-wait
    baseline when a workload has no measured ``collective_wait`` phase: a
    worker whose measured wait dwarfs this analytic floor is waiting on a
    peer, not on the wire.
    """
    if total_bytes <= 0.0 or link_bandwidth_gbps <= 0.0:
        return 0.0
    return float(total_bytes) / (link_bandwidth_gbps * 1e9 / 8.0)
