"""kubeflow_tpu_torch/gpu/topology.py (``NodeTopology``, ``parse_topology``,
``pod_gpu_chips``) and gpu/env.py (``torchrun_worker_env``), on the CPU.

The cases mirror ``tests/test_topology.py``'s, with GPU nodes of 8 cards in
place of TPU hosts: a table written here gives each topology's cards,
nodes and cards a pod; the pod accounting is held against JAX
``pod_tpu_chips`` on the same pods with the resource renamed.
"""

import pytest

from kubeflow_tpu.tpu import topology as jtopo
from kubeflow_tpu_torch.data import per_host_shard
from kubeflow_tpu_torch.gpu.env import (coordinator_address, env_list_to_dict,
                                        torchrun_worker_env, worker_hostnames)
from kubeflow_tpu_torch.gpu.topology import (ACCELERATORS, NODE_LABEL_PRODUCT, RESOURCE_GPU,
                                             NodeTopology, parse_topology, pod_gpu_chips)

#: label -> (cards, nodes, cards a pod, label)
KNOWN = {
    "1": (1, 1, 1, "1x1"),
    "4": (4, 1, 4, "1x4"),
    "8": (8, 1, 8, "1x8"),
    "1x8": (8, 1, 8, "1x8"),
    "16": (16, 2, 8, "2x8"),
    "2x8": (16, 2, 8, "2x8"),
    "4x8": (32, 4, 8, "4x8"),
    "128": (128, 16, 8, "16x8"),
}


@pytest.mark.parametrize("label", sorted(KNOWN))
def test_h100_known_topologies(label):
    chips, hosts, per_pod, canonical = KNOWN[label]
    t = parse_topology("h100", label)
    assert (t.num_chips, t.num_hosts, t.chips_per_pod, t.label) == \
        (chips, hosts, per_pod, canonical)
    assert t.is_multi_host == (hosts > 1)
    assert parse_topology("h100", t.label) == t


@pytest.mark.parametrize("label,message", [
    ("12", "not divisible by 8"),          # a partial second node
    ("2x4", "whole nodes of 8"),
    ("1x16", "exceeds 8"),
    ("2x2x2", "N or NODESxGPUS"),
    ("bogus", "expected N or NODESxGPUS"),
    ("0", "must be >= 1"),
    ("256x8", "exceeds max 1024"),
])
def test_invalid_topologies(label, message):
    with pytest.raises(ValueError, match=message):
        parse_topology("h100", label)


def test_unknown_generation():
    with pytest.raises(ValueError, match="unknown GPU generation 'a100'"):
        parse_topology("a100", "8")


def test_node_selector_and_limits():
    t = parse_topology("h100", "4x8")
    assert t.node_selector() == {NODE_LABEL_PRODUCT: "NVIDIA-H100-80GB-HBM3"}
    assert NODE_LABEL_PRODUCT == "nvidia.com/gpu.product"
    assert t.resource_limits() == {"nvidia.com/gpu": "8"}
    assert ACCELERATORS["h100"].gpus_per_host == 8


def test_single_node_gets_all_cards():
    assert parse_topology("h100", "16").is_multi_host
    single = parse_topology("h100", "4")
    assert not single.is_multi_host
    assert single.resource_limits() == {RESOURCE_GPU: "4"}


def test_peak_flops():
    t = parse_topology("h100", "4x8")
    assert t.peak_bf16_tflops() == 32 * ACCELERATORS["h100"].bf16_tflops_per_chip
    assert NodeTopology("h100", 32) == t


@pytest.mark.parametrize("pod", [
    {"spec": {"containers": [{"resources": {"limits": {"R": "4"}}},
                             {"resources": {"limits": {"R": "2"}}}]}},
    {"spec": {"containers": [{"resources": {"limits": {"R": "8"}}}]},
     "status": {"phase": "Succeeded"}},
    {"spec": {"containers": [{"resources": {"limits": {"R": "8"}}}]},
     "status": {"phase": "Failed"}},
    {"spec": {"containers": [{"resources": {"limits": {"R": "8"}}}]},
     "status": {"phase": "Running"}},
    {"spec": {"containers": [{"resources": {}}, {}]}},
    {},
])
def test_pod_gpu_chips_is_pod_tpu_chips(pod):
    import json

    text = json.dumps(pod)
    want = jtopo.pod_tpu_chips(json.loads(text.replace('"R"', f'"{jtopo.RESOURCE_TPU}"')))
    assert pod_gpu_chips(json.loads(text.replace('"R"', f'"{RESOURCE_GPU}"'))) == want


def test_coordinator_address_is_pod0_headless_dns():
    assert coordinator_address("mynb", "team-a") == \
        "mynb-0.mynb.team-a.svc.cluster.local:29500"
    assert worker_hostnames("nb", "ns1", 2) == \
        "nb-0.nb.ns1.svc.cluster.local,nb-1.nb.ns1.svc.cluster.local"


@pytest.mark.parametrize("label,env", [
    ("4x8", {"MASTER_ADDR": "nb-0.nb.ns1.svc.cluster.local", "MASTER_PORT": "29500",
             "NNODES": "4", "NPROC_PER_NODE": "8", "WORLD_SIZE": "32"}),
    ("4", {"MASTER_ADDR": "nb-0.nb.ns1.svc.cluster.local", "MASTER_PORT": "29500",
           "NNODES": "1", "NPROC_PER_NODE": "4", "WORLD_SIZE": "4"}),
])
def test_torchrun_worker_env_deterministic_and_complete(label, env):
    t = parse_topology("h100", label)
    env1 = torchrun_worker_env(t, "nb", "ns1")
    assert env1 == torchrun_worker_env(t, "nb", "ns1")  # webhook re-injection
    assert [e["name"] for e in env1] == sorted(env)
    assert env_list_to_dict(env1) == env
    assert "RANK" not in env_list_to_dict(env1)  # left to runtime, per process
    extra = env_list_to_dict(torchrun_worker_env(t, "nb", "ns1", extra={"NCCL_DEBUG": "WARN"}))
    assert extra == {**env, "NCCL_DEBUG": "WARN"}


def test_per_host_shard_reads_the_torchrun_env(monkeypatch):
    env = env_list_to_dict(torchrun_worker_env(parse_topology("h100", "2x8"), "nb", "ns"))
    monkeypatch.setenv("WORLD_SIZE", env["WORLD_SIZE"])
    monkeypatch.setenv("RANK", "9")  # torchrun's, per process
    assert per_host_shard(256) == (9 * 16, 16)
