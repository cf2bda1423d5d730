"""Test configuration: force JAX onto 8 virtual CPU devices.

Multi-chip hardware is unavailable in CI; all sharding/parallelism tests run
against a virtual 8-device CPU mesh (the reference's e2e harness likewise
tests distributed control flow against CPU-only CI clusters — SURVEY.md §4).
Must run before the first ``import jax`` anywhere in the test session.
"""

import os

os.environ["JAX_PLATFORMS"] = "cpu"
xla_flags = os.environ.get("XLA_FLAGS", "")
if "xla_force_host_platform_device_count" not in xla_flags:
    os.environ["XLA_FLAGS"] = (xla_flags + " --xla_force_host_platform_device_count=8").strip()

# Site customization (e.g. a preregistered TPU PJRT plugin) may override
# jax_platforms after env is read; force CPU at the config level too.
import jax  # noqa: E402

jax.config.update("jax_platforms", "cpu")

import pytest  # noqa: E402

from kubeflow_tpu.apiserver.store import Store  # noqa: E402
from kubeflow_tpu.apiserver.client import Client  # noqa: E402
from kubeflow_tpu.runtime.manager import Manager  # noqa: E402
from kubeflow_tpu.runtime.metrics import METRICS  # noqa: E402


def pytest_configure(config):
    config.addinivalue_line(
        "markers",
        "slow: heavyweight tests (multi-device parity, long decode loops); "
        "tier-1 excludes them with -m 'not slow', the owning CI job runs "
        "them (multichip-e2e, disagg-serving-e2e)",
    )
    config.addinivalue_line(
        "markers",
        "cuda: needs an NVIDIA GPU and nvcc (the PyTorch/CUDA port's kernels); "
        "skips with a reason elsewhere, runs on the card with "
        "`python -m pytest tests/test_torch_*.py -m cuda`",
    )


@pytest.fixture()
def store():
    return Store()


@pytest.fixture()
def client(store):
    return Client(store)


@pytest.fixture()
def manager():
    mgr = Manager()
    yield mgr
    mgr.stop()


@pytest.fixture(autouse=True)
def _reset_metrics():
    METRICS.reset()
    yield
