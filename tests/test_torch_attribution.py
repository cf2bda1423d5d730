"""kubeflow_tpu_torch/training/attribution.py against
kubeflow_tpu/training/attribution.py, on the CPU.

The port's counterparts of ``tests/test_attribution.py``'s
``TestPriceCallable``, ``TestResNetAttribution``,
``test_gpt_walk_counts_the_scanned_stack``, ``TestAttributionReport``,
``test_record_step_peak_hbm_publishes_gauges`` and
``test_memory_stats_from_a_compiled_executable`` (the port's footprint),
then the cross-package checks:

- the ResNet walk's names, kinds, details, fused flags and counts equal
  JAX's at batch 1 and 32 x 32 (stage 4 below the 4-pixel fusable floor,
  stage 3's identity blocks at 2 x 2) and at 224 x 224 with the s2d stem;
- each module's counted FLOPs within 10% of XLA's CPU cost analysis at
  224 x 224 (measured 0.95-1.08: the counter sees only products, XLA also
  counts elementwise work and the f32 -> bf16 weight casts, and counts a
  SAME convolution's padded taps as zero); the GPT block and loss head
  within 5% (measured 0.98 and 0.96);
- ``attribution_report`` gives JAX's fractions, ``measured`` and
  ``step_seconds`` to 1e-12 on identical module lists and a stub clock.

Then the bench rows: both ``train()``s carry ``autotune``, ``attribution``
and ``peak_hbm_bytes``, and their ``compute`` phase holds the step's work
(the clock ends it at a device synchronize, as bench.py's
``block_until_ready``).
"""

import json
import time
from dataclasses import fields

import pytest
import torch

from kubeflow_tpu_torch.gpu.profiling import StepClock
from kubeflow_tpu_torch.training.attribution import (TRAIN_STEP_FACTOR, ModuleCost,
                                                     attribute_gpt, attribute_resnet,
                                                     attribution_report, footprint,
                                                     price_callable, record_step_peak_hbm)

META = torch.device("meta")


def _meta(*shape, dtype=torch.float32):
    return torch.empty(*shape, dtype=dtype, device=META)


# -- price_callable -----------------------------------------------------------

class TestPriceCallable:
    def test_prices_from_meta_tensors_without_allocating(self):
        cost = price_callable(lambda x, y: x @ y, _meta(64, 128), _meta(128, 32), name="mm")
        # one [64,128]@[128,32] = 2*64*128*32 forward flops, x train factor
        assert cost.flops == pytest.approx(2 * 64 * 128 * 32 * TRAIN_STEP_FACTOR, rel=0.01)
        # eager traffic: both inputs read, the output written, x train factor
        assert cost.hbm_bytes == (64 * 128 + 128 * 32 + 64 * 32) * 4 * TRAIN_STEP_FACTOR
        assert cost.verdict in ("compute-bound", "hbm-bound")
        assert cost.est_seconds > 0
        assert cost.peak_hbm_bytes > 0

    def test_tensors_on_a_device_are_priced_as_meta(self):
        a, b = torch.ones(64, 128), torch.ones(128, 32)
        seen = []
        cost = price_callable(lambda x, y: seen.append(x.device) or x @ y, a, b, name="mm")
        assert seen == [META]
        assert cost.flops == price_callable(lambda x, y: x @ y, _meta(64, 128),
                                            _meta(128, 32), name="mm").flops

    def test_a_module_on_a_device_is_refused(self):
        with pytest.raises(ValueError, match="build it under torch.device"):
            price_callable(lambda m, x: m(x), torch.nn.Linear(4, 4), _meta(2, 4), name="lin")

    def test_count_scales_all_applications(self):
        a = _meta(16, 16)
        one = price_callable(lambda x: x @ x, a, name="sq", count=1)
        four = price_callable(lambda x: x @ x, a, name="sq", count=4)
        assert four.flops == pytest.approx(4 * one.flops)
        assert four.hbm_bytes == pytest.approx(4 * one.hbm_bytes)

    def test_roofline_classification_tracks_intensity(self):
        # big square matmul: high arithmetic intensity -> compute-bound
        big = _meta(2048, 2048)
        mm = price_callable(lambda x, y: x @ y, big, big, name="big_mm")
        assert mm.verdict == "compute-bound"
        # elementwise add: no product, 12 bytes an element -> hbm-bound
        vec = _meta(1 << 20)
        add = price_callable(lambda x, y: x + y, vec, vec, name="add")
        assert add.verdict == "hbm-bound"
        assert mm.intensity > add.intensity


def test_footprint_is_the_memory_analysis_analog():
    """``peak_hbm_bytes`` is argument + output + temp (JAX's memory_stats
    sum); temp is the most intermediate bytes alive at once."""
    mem = footprint(lambda x: torch.tanh(x @ x) @ x, _meta(32, 32))
    assert mem["peak_hbm_bytes"] == sum(
        v for k, v in mem.items() if k.endswith("_bytes") and k != "peak_hbm_bytes")
    assert mem["argument_bytes"] == 32 * 32 * 4
    assert mem["output_bytes"] == 32 * 32 * 4
    # x @ x and its tanh live together for a moment (2 x 4 KiB)
    assert mem["temp_bytes"] == 2 * 32 * 32 * 4

    def chain(x, n):
        for _ in range(n):
            x = torch.relu(x + 1)  # frees the previous x and x + 1
        return x

    # at most the previous x, x + 1 and its relu are alive, however long
    for n in (3, 30):
        assert footprint(chain, _meta(1024), n)["temp_bytes"] == 3 * 1024 * 4


# -- ResNet-50 walk -----------------------------------------------------------

@pytest.fixture(scope="module")
def resnet_costs():
    return attribute_resnet(batch=1, image=224, generation="h100")


class TestResNetAttribution:
    def test_walk_covers_the_whole_model(self, resnet_costs):
        names = [c.name for c in resnet_costs]
        assert names[0] == "stem" and names[-1] == "classifier_head"
        blocks = [n for n in names if n.startswith("stage")]
        assert len(blocks) == 16  # ResNet-50: 3 + 4 + 6 + 3
        assert "stage2_block1" in blocks and "stage4_block3" in blocks

    def test_fused_set_matches_the_model_predicate(self, resnet_costs):
        fused = {c.name for c in resnet_costs if c.fused}
        assert fused == {c.name for c in resnet_costs if c.name.startswith("stage")}
        assert len(fused) == 16

    def test_every_block_is_priced_with_flops_bytes_and_verdict(self, resnet_costs):
        for c in resnet_costs:
            assert c.flops > 0, c.name
            assert c.hbm_bytes > 0, c.name
            assert c.peak_hbm_bytes > 0, c.name
            assert c.verdict in ("compute-bound", "hbm-bound"), c.name

    def test_only_stem_and_head_remain_unfused(self, resnet_costs):
        report = attribution_report(resnet_costs, step_seconds=0.1, generation="h100")
        unfused = report.top_sinks(6, fused=False)
        assert {c.name for c in unfused} == {"stem", "classifier_head"}
        top_fused = report.top_sinks(6, fused=True)
        assert any("transition" in c.detail for c in top_fused)

    def test_coverage_counts_fused_bottlenecks(self, resnet_costs):
        report = attribution_report(resnet_costs, step_seconds=0.1, generation="h100")
        assert report.coverage() == {"fused": 16, "total": 16}

    def test_projection_blocks_are_labeled(self, resnet_costs):
        by_name = {c.name: c for c in resnet_costs}
        assert by_name["stage1_block1"].detail == "projection/transition"
        for stage in (2, 3, 4):
            assert by_name[f"stage{stage}_block1"].detail == "strided+projection/transition"
        assert by_name["stage3_block2"].detail == "identity"

    def test_generation_defaults_to_the_card(self):
        with pytest.raises(RuntimeError, match="not a CUDA device"):
            attribute_resnet(batch=1, image=32, device="cpu")


# -- GPT walk -----------------------------------------------------------------

def _gpt_kw():
    return dict(vocab_size=256, d_model=64, n_layers=3, n_heads=4, d_ff=128, max_seq=32)


def test_gpt_walk_counts_the_scanned_stack():
    from kubeflow_tpu_torch.models.gpt import GptConfig

    cfg = GptConfig(**_gpt_kw())
    costs = attribute_gpt(cfg, batch=2, seq=32, generation="h100")
    block = next(c for c in costs if c.kind == "gpt_block")
    assert block.count == 3
    assert block.flops / block.count > 0
    head = next(c for c in costs if c.kind == "loss_head")
    assert head.fused and head.detail == "blockwise"
    unfused = attribute_gpt(cfg, batch=2, seq=32, fused_loss=False, generation="h100")
    assert not next(c for c in unfused if c.kind == "loss_head").fused


# -- report: fractions decompose the MEASURED step ----------------------------

class TestAttributionReport:
    def _clock(self, steps=3):
        clock = StepClock()
        for _ in range(steps):
            with clock.data_wait():
                time.sleep(0.002)
            with clock.compute():
                time.sleep(0.004)
            with clock.fetch():
                time.sleep(0.001)
            clock.end_step()
        return clock

    def test_fractions_sum_to_one_and_match_the_clock(self, resnet_costs):
        clock = self._clock()
        report = attribution_report(resnet_costs, clock=clock, generation="h100")
        assert sum(report.fractions.values()) == pytest.approx(1.0)
        reconstructed = report.step_seconds * sum(report.fractions.values())
        assert reconstructed == pytest.approx(report.step_seconds, rel=0.05)
        assert report.step_seconds == pytest.approx(clock.summary()["total"], rel=1e-6)
        assert report.fractions["fused_compute"] > report.fractions["unfused_compute"] > 0

    def test_steps_per_record_normalizes_bench_windows(self, resnet_costs):
        clock = self._clock(steps=2)
        whole = attribution_report(resnet_costs, clock=clock, generation="h100")
        per_10 = attribution_report(resnet_costs, clock=clock, steps_per_record=10,
                                    generation="h100")
        assert per_10.step_seconds == pytest.approx(whole.step_seconds / 10)

    def test_render_and_to_dict(self, resnet_costs):
        report = attribution_report(resnet_costs, step_seconds=0.05, generation="h100")
        text = report.render(top_n=5)
        assert "Attribution report (h100: 989 TF/s peak, 3350 GB/s HBM)" in text
        assert "strided+projection" in text
        d = json.loads(json.dumps(report.to_dict()))
        assert d["modules"] == len(resnet_costs)
        assert d["fused_modules"] == 16
        assert d["coverage"] == {"fused": 16, "total": 16}
        assert len(d["top_unfused_sinks"]) == 2
        assert all(s["verdict"] for s in d["top_unfused_sinks"])
        assert len(d["top_fused_sinks"]) == 5
        assert "fused coverage: 16/16" in report.render()

    def test_without_clock_everything_is_unfused_compute(self):
        report = attribution_report([], step_seconds=0.2, generation="h100")
        assert report.fractions == {"data_wait": 0.0, "fused_compute": 0.0,
                                    "unfused_compute": 1.0, "other": 0.0}


def test_record_step_peak_hbm_publishes_gauges():
    from kubeflow_tpu_torch.runtime.metrics import METRICS

    mem = {"peak_hbm_bytes": 1234, "argument_bytes": 1000,
           "output_bytes": 200, "temp_bytes": 34}
    assert record_step_peak_hbm(mem) == 1234
    text = METRICS.render()
    assert "training_step_peak_hbm_bytes 1234" in text
    assert 'training_step_hbm_bytes{component="temp"} 34' in text
    assert record_step_peak_hbm(None) is None


# -- against the JAX package ---------------------------------------------------

def _walks(batch, image, stem):
    from kubeflow_tpu.training import attribution as jattr

    return (jattr.attribute_resnet(batch=batch, image=image, stem=stem, generation="v5e"),
            attribute_resnet(batch=batch, image=image, stem=stem, generation="h100"))


@pytest.fixture(scope="module")
def walks_224():
    return _walks(1, 224, "s2d")


def _structure(costs):
    return [(c.name, c.kind, c.detail, c.fused, c.count) for c in costs]


def test_walk_structure_equals_jax_below_the_fusable_floor():
    jax_costs, port_costs = _walks(1, 32, "conv7x7")
    assert _structure(port_costs) == _structure(jax_costs)
    fused = {c.name: c.fused for c in port_costs}
    assert fused["stage3_block1"] and not fused["stage3_block2"]  # 2 x 2 < 4
    assert not any(fused[f"stage4_block{j}"] for j in (1, 2, 3))


def test_walk_structure_equals_jax_at_224(walks_224):
    jax_costs, port_costs = walks_224
    assert _structure(port_costs) == _structure(jax_costs)
    assert attribution_report(port_costs, step_seconds=1.0, generation="h100").coverage() \
        == {"fused": 16, "total": 16}


def test_module_flops_within_10_percent_of_xla(walks_224):
    jax_costs, port_costs = walks_224
    ratios = {p.name: p.flops / j.flops for j, p in zip(jax_costs, port_costs)}
    assert all(0.9 <= r <= 1.1 for r in ratios.values()), ratios


def test_gpt_flops_within_5_percent_of_xla():
    from kubeflow_tpu.models.gpt import GptConfig as JaxConfig
    from kubeflow_tpu.training import attribution as jattr
    from kubeflow_tpu_torch.models.gpt import GptConfig

    jax_costs = jattr.attribute_gpt(JaxConfig(**_gpt_kw()), batch=2, seq=32, generation="v5e")
    port_costs = attribute_gpt(GptConfig(**_gpt_kw()), batch=2, seq=32, generation="h100")
    assert _structure(port_costs) == _structure(jax_costs)
    for j, p in zip(jax_costs, port_costs):
        assert 0.95 <= p.flops / j.flops <= 1.05, (p.name, p.flops / j.flops)


class _StubClock:
    def __init__(self, summary):
        self._summary = summary

    def summary(self):
        return dict(self._summary)


@pytest.mark.parametrize("summary,spr", [
    ({"data_wait": 0.01, "compute": 0.20, "fetch": 0.002, "other": 0.003, "total": 0.215}, 1),
    ({"data_wait": 0.0, "compute": 0.33, "fetch": 0.05, "other": 0.01, "total": 0.39}, 4),
    ({"compute": 0.5, "total": 0.4}, 1),          # compute past total: other clips at 0
    ({"data_wait": 0.1, "total": 0.1}, 1),         # no compute
    ({}, 1),                                       # an empty clock: no fractions
    (None, 1),                                     # no clock: step_seconds
])
def test_report_arithmetic_equals_jax(resnet_costs, summary, spr):
    from kubeflow_tpu.training import attribution as jattr

    jax_mods = [jattr.ModuleCost(**{f.name: getattr(c, f.name) for f in fields(ModuleCost)})
                for c in resnet_costs]
    kw = ({"clock": _StubClock(summary), "steps_per_record": spr} if summary is not None
          else {"step_seconds": 0.25})
    want = jattr.attribution_report(jax_mods, generation="v5e", **kw)
    got = attribution_report(resnet_costs, generation="h100", **kw)
    assert got.step_seconds == pytest.approx(want.step_seconds, abs=1e-12)
    assert got.measured.keys() == want.measured.keys()
    assert got.fractions.keys() == want.fractions.keys()
    for k in want.measured:
        assert got.measured[k] == pytest.approx(want.measured[k], abs=1e-12)
    for k in want.fractions:
        assert got.fractions[k] == pytest.approx(want.fractions[k], abs=1e-12)
    assert got.coverage() == want.coverage()
    assert [m.name for m in got.top_sinks(5, fused=True)] == \
        [m.name for m in want.top_sinks(5, fused=True)]


# -- the bench rows -----------------------------------------------------------

def _bench_runs():
    from kubeflow_tpu_torch.training import gpt, resnet

    return {
        "resnet": resnet.train(resnet.tiny_config(), steps=2, device="cpu",
                               fused_blocks="auto"),
        "gpt": gpt.train(gpt.tiny_config(32), batch=2, seq=32, steps=2, device="cpu",
                         autotune=True),
    }


@pytest.fixture(scope="module")
def bench_runs():
    return _bench_runs()


@pytest.mark.parametrize("which", ["resnet", "gpt"])
def test_bench_rows_carry_autotune_attribution_and_peak(bench_runs, which):
    out = bench_runs[which]
    assert "peak_hbm_bytes" in out and out["peak_hbm_bytes"] is None  # no CPU counter
    row = out["autotune"]
    assert row["family"] == which and row["errors"] == 0
    att = out["attribution"]
    assert "error" not in att, att
    assert sum(att["fractions"].values()) == pytest.approx(1.0, abs=1e-3)
    assert att["generation"] == "h100"
    if which == "resnet":
        assert row["measured"] == 2
        assert set(out["fused_calibration"]) == {"fused", "unfused"}
        assert out["fused_blocks"] == row["chosen"]["fused_blocks"]
        assert att["modules"] == 6 and att["coverage"]["total"] == 4
    else:
        # remat priced dearer and pruned; the other measured and chosen
        assert row["swept"] == 2 and row["pruned"] == 1 and row["measured"] == 1
        assert row["chosen"] == {"remat": False} and out["remat"] is False


@pytest.mark.parametrize("which", ["resnet", "gpt"])
def test_compute_phase_holds_the_steps_work(bench_runs, which):
    """The clock ends ``compute`` at the device synchronize: on the CPU the
    step runs inside it, and ``fetch`` is only the host read."""
    bd = bench_runs[which]["step_breakdown"]
    step_s = sum(bench_runs[which]["step_ms"]) / len(bench_runs[which]["step_ms"]) / 1e3
    assert bd["device_compute_s_per_step"] >= 0.8 * step_s, bd
    assert bd["fetch_s_per_step"] < 0.1 * bd["device_compute_s_per_step"], bd


def test_pinned_rows_and_the_cpu_attribution():
    from kubeflow_tpu_torch.training import resnet
    from kubeflow_tpu_torch.training.attribution import loop_generation

    out = resnet.train(resnet.tiny_config(), steps=1, device="cpu", fused_blocks=False)
    assert out["autotune"] == {"family": "resnet", "chosen": {"fused_blocks": False},
                               "pinned": "fused_blocks=False"}
    assert "fused_calibration" not in out
    # the CPU loop prices for the catalog's card, as the driver does
    assert loop_generation("cpu") == "h100" and loop_generation("meta") == "h100"
    assert "error" not in out["attribution"] and out["attribution"]["generation"] == "h100"
    with pytest.raises(ValueError, match="fused_blocks must be"):
        resnet.train(resnet.tiny_config(), steps=1, device="cpu", fused_blocks="sometimes")
