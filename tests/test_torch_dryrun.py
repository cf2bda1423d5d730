"""kubeflow_tpu_torch/entry.py ``dryrun_multichip`` against __graft_entry__.dryrun_multichip.

The dry run runs in worlds of 8 and 4 gloo ranks (~15-19 s each), one sharded
train step of each parallel path, then JAX's timed multichip row in a world
of its own; it asserts itself what JAX's asserts
(finite losses, no progress lost across the composite restore at another
factorization, gpipe / interleaved / overlap parity within 1e-5, the
interleaved bubble smaller) and more: BERT's tp x sp loss within 1e-4 of
one process's ``BertForMaskedLM``, the pipeline's of its stages in turn,
MoE's of the mesh-less layer. The tests read the summaries: JAX's
factorizations of ``n`` devices, rank by rank.
"""

import pytest

from kubeflow_tpu_torch.entry import dryrun_multichip


@pytest.fixture(scope="module", params=[8, 4])
def summary(request):
    return dryrun_multichip(request.param, device="cpu", timeout=240)


def test_factorizations_are_jaxs(summary):
    n = summary["n"]
    assert summary["device"] == "cpu"
    assert (summary["resnet"]["dp"], summary["resnet"]["fsdp"]) == (n // 2, 2)
    bert = summary["bert"]
    assert (bert["dp"], bert["seq"], bert["model"]) == (n // 4, 2, 2)
    assert summary["pipeline"]["pp"] == 2 and summary["moe"]["ep"] == 2
    a, b = summary["composite"]["a"], summary["composite"]["b"]
    assert (a["pipe"], a["model"], b["pipe"], b["model"]) == (2, 2, 2, 1)
    assert a["data"] * a["fsdp"] * a["pipe"] * a["model"] == n
    assert b["data"] * b["fsdp"] * b["pipe"] == n


def test_every_phase_trained(summary):
    for phase in ("resnet", "bert", "pipeline", "moe"):
        assert summary[phase]["loss"] > 0.0, phase
    assert abs(summary["bert"]["loss"] - summary["bert"]["one_process_loss"]) <= 1e-4 * 8
    assert any("model" in spec for spec in summary["bert"]["model_split"].values())
    c = summary["composite"]
    assert c["loss_b"] < c["loss_a"] + 1e-3
    assert sorted(c["parity"]) == ["gpipe_eager", "gpipe_overlap", "interleaved_eager"]
    assert c["max_dloss"] <= 1e-5 * max(1.0, c["parity"]["gpipe_eager"])


def test_bert_is_jaxs_tiny_config(summary):
    """The dry run's BERT is ``BertConfig.tiny()`` as JAX's dry run builds
    it: 4 heads of 16 (the flash kernels' head_dim 16 on the card)."""
    from kubeflow_tpu.models.bert import BertConfig as JBertConfig

    jcfg = JBertConfig.tiny()
    bert = summary["bert"]
    assert (bert["heads"], bert["head_dim"]) == (jcfg.num_heads, jcfg.head_dim) == (4, 16)


def test_timed_multichip_row_is_jaxs(summary):
    """The dry run ends with JAX's timed row over the same ranks, at the dry
    run's shapes, held as JAX's dry run holds it."""
    from kubeflow_tpu_torch.entry import DRYRUN_MULTICHIP

    row, n = summary["multichip"], summary["n"]
    assert "error" not in row
    assert row["metric"] == f"multichip_composite_tokens_per_sec_per_chip_{n}dev"
    for name in ("value", "bubble_fraction", "comm_bytes_per_step", "scaling_efficiency"):
        assert row[name] is not None, name
    assert row["n_devices"] == n and row["platform"] == "cpu"
    assert (DRYRUN_MULTICHIP["timed_steps"], DRYRUN_MULTICHIP["repeats"]) == (3, 2)
    assert row["value"] > 0 and row["scaling_efficiency"] > 0


@pytest.mark.parametrize("fault", [{"error": "boom"}, {"value": None},
                                   {"bubble_fraction": None}, {"comm_bytes_per_step": None},
                                   {"scaling_efficiency": None}])
def test_timed_row_check_raises_without_assert(fault):
    """``check_timed_row`` raises ``AssertionError`` itself, so that
    ``python -O`` (which drops ``assert``) keeps the dry run's checks."""
    from kubeflow_tpu_torch.entry import check_timed_row

    row = {"value": 1.0, "bubble_fraction": 0.1, "comm_bytes_per_step": {"total": 1},
           "scaling_efficiency": 0.9}
    assert check_timed_row(row) is row
    with pytest.raises(AssertionError):
        check_timed_row({**row, **fault})
