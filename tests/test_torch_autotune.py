"""kubeflow_tpu_torch/training/autotune.py against
kubeflow_tpu/training/autotune.py, on the CPU.

The port's counterparts of ``tests/test_autotune.py``'s ``TestSweepEngine``,
``test_measure_steps_returns_median_seconds``,
``test_quick_sweeps_run_on_cpu`` and ``test_cli_requires_quick``; then
both packages' ``sweep`` on the same scripted price and measure functions
(every pruning, error and fallback path) giving the same ``chosen``,
candidate table and ``to_row()``; the GPT bench sweep's price (remat costs
more than no remat, scan_blocks nothing); the strict sweeps of the port's
bench loops raising on a candidate that fails to run; and, on the card, the
quick ResNet sweep through the fused-block kernels.
"""

import json

import pytest
import torch

from kubeflow_tpu_torch.training.autotune import (AutotuneResult, TunedCandidate,
                                                  autotune_gpt_quick, autotune_resnet_quick,
                                                  gpt_quick_candidates, main, measure_steps,
                                                  sweep)


class TestSweepEngine:
    def test_measured_minimum_wins(self):
        times = {"a": 0.03, "b": 0.01, "c": 0.02}
        result = sweep("t", [{"k": k} for k in "abc"], measure=lambda kn: times[kn["k"]])
        assert result.chosen == {"k": "b"}
        assert all(c.measured_seconds == times[c.knobs["k"]] for c in result.candidates)

    def test_price_prunes_beyond_keep(self):
        est = {"a": 3.0, "b": 1.0, "c": 2.0, "d": 4.0}
        measured = []

        def measure(kn):
            measured.append(kn["k"])
            return est[kn["k"]] / 10

        result = sweep("t", [{"k": k} for k in "abcd"], measure=measure,
                       price=lambda kn: est[kn["k"]], keep=2)
        assert sorted(measured) == ["b", "c"]
        assert result.chosen == {"k": "b"}
        assert {c.knobs["k"] for c in result.candidates if c.pruned} == {"a", "d"}

    def test_measurement_can_overturn_the_price(self):
        # the ResNet sweep on the card: the fused set is priced cheaper
        # (x 0.7) and measured slower; clocks decide
        est = {"a": 2.0, "b": 1.0}
        meas = {"a": 0.01, "b": 0.05}
        result = sweep("t", [{"k": k} for k in "ab"], measure=lambda kn: meas[kn["k"]],
                       price=lambda kn: est[kn["k"]], keep=2)
        assert result.chosen == {"k": "a"}

    def test_errors_are_recorded_not_fatal(self):
        def measure(kn):
            if kn["k"] == "boom":
                raise RuntimeError("kernel exploded")
            return 0.02

        result = sweep("t", [{"k": "boom"}, {"k": "ok"}], measure=measure)
        assert result.chosen == {"k": "ok"}
        boom = next(c for c in result.candidates if c.knobs["k"] == "boom")
        assert boom.error and "exploded" in boom.error

    def test_price_errors_keep_candidate_measurable(self):
        def price(kn):
            if kn["k"] == "unpriceable":
                raise ValueError("no cost analysis for collectives")
            return 1.0

        meas = {"unpriceable": 0.01, "plain": 0.05}
        result = sweep("t", [{"k": "unpriceable"}, {"k": "plain"}],
                       measure=lambda kn: meas[kn["k"]], price=price, keep=2)
        assert result.chosen == {"k": "unpriceable"}

    def test_all_measurements_failing_falls_back_to_price(self):
        def measure(kn):
            raise RuntimeError("no hardware")

        result = sweep("t", [{"k": "a"}, {"k": "b"}], measure=measure,
                       price=lambda kn: {"a": 2.0, "b": 1.0}[kn["k"]], keep=2)
        assert result.chosen == {"k": "b"}

    def test_everything_failing_falls_back_to_first(self):
        def bomb(kn):
            raise RuntimeError("nope")

        result = sweep("t", [{"k": "first"}, {"k": "second"}], measure=bomb, price=bomb)
        assert result.chosen == {"k": "first"}

    def test_row_and_dict_are_json_safe(self):
        result = sweep("t", [{"k": 1}, {"k": 2}], measure=lambda kn: 0.01 * kn["k"])
        row = json.loads(json.dumps(result.to_row()))
        assert row["family"] == "t"
        assert row["chosen"] == {"k": 1}
        assert row["swept"] == 2 and row["measured"] == 2
        assert row["pruned"] == 0 and row["errors"] == 0
        full = json.loads(json.dumps(result.to_dict()))
        assert len(full["candidates"]) == 2
        assert "est=" in result.render() and "chosen" in result.render()

    def test_result_types(self):
        c = TunedCandidate(knobs={"x": 1})
        assert c.to_dict()["knobs"] == {"x": 1}
        r = AutotuneResult(family="f", chosen={"x": 1}, candidates=[c])
        assert r.to_row()["swept"] == 1

    def test_no_candidates_is_refused(self):
        with pytest.raises(ValueError, match="at least one candidate"):
            sweep("t", [], measure=lambda kn: 0.0)


def test_measure_steps_returns_median_seconds():
    calls = []
    assert measure_steps(lambda: calls.append(1), steps=3) >= 0.0
    assert len(calls) == 3


# -- the quick sweeps ---------------------------------------------------------

@pytest.mark.parametrize("quick_fn,family", [
    (autotune_resnet_quick, "resnet"),
    (autotune_gpt_quick, "gpt"),
])
def test_quick_sweeps_run_on_cpu(quick_fn, family):
    result = quick_fn(steps=1, device="cpu")
    assert result.family == family
    assert result.quick is True
    assert result.chosen in [c.knobs for c in result.candidates]
    assert any(c.measured_seconds is not None for c in result.candidates)
    assert result.to_row()["swept"] >= 2
    assert not any(c.error for c in result.candidates)
    if family == "gpt":  # remat's recompute prices it out
        remat = next(c for c in result.candidates if c.knobs["remat"])
        assert remat.pruned and remat.est_seconds > min(
            c.est_seconds for c in result.candidates)


def test_quick_gpt_measures_through_the_flash_attention(monkeypatch):
    """The quick GPT sweep's measured build is ``GptLM``'s default,
    ``causal_flash_attention``, as JAX's ``GptLM(cfg)``: every layer's
    forward reaches the flash wrapper (its plain version on CPU tensors,
    the kernels on the card); only the priced build on meta tensors takes
    the plain attention."""
    from kubeflow_tpu_torch.ops import flash_attention as tfa

    seen = []
    real = tfa.flash_attention_fwd

    def spy(q, *args, **kw):
        seen.append((q.device.type, q.shape[-1]))
        return real(q, *args, **kw)

    monkeypatch.setattr(tfa, "flash_attention_fwd", spy)
    result = autotune_gpt_quick(steps=1, device="cpu")
    measured = [c for c in result.candidates if c.measured_seconds is not None]
    # a warm-up and one timed step a measured candidate, 2 layers each
    assert len(seen) >= 2 * 2 * len(measured) > 0
    assert set(seen) == {("cpu", 16)}


def test_quick_sweeps_default_to_the_card():
    if torch.cuda.is_available():
        pytest.skip("this host has a card: the default device is usable")
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        autotune_resnet_quick(steps=1)


def test_gather_mode_rows_wait_for_several_devices():
    assert all("gather_mode" not in c for c in gpt_quick_candidates(1))
    assert {c["gather_mode"] for c in gpt_quick_candidates(8)} == {"overlap", "eager"}


def test_cli_requires_quick():
    with pytest.raises(SystemExit):
        main(["--family", "resnet"])


def test_cli_quick_prints_the_audit(capsys):
    assert main(["--quick", "--family", "resnet", "--steps", "1", "--device", "cpu"]) == 0
    out = json.loads(capsys.readouterr().out)
    assert set(out) == {"resnet"} and out["resnet"]["measured"] >= 1


# -- against the JAX package ---------------------------------------------------

class _Boom(RuntimeError):
    pass


def _scripted(prices, times):
    """price/measure functions from tables; a missing entry raises."""
    def price(kn):
        if kn["k"] not in prices:
            raise ValueError(f"no price for {kn['k']}")
        return prices[kn["k"]]

    def measure(kn):
        if kn["k"] not in times:
            raise _Boom(f"{kn['k']} did not run")
        return times[kn["k"]]

    return price, measure


SCENARIOS = {
    "measured_minimum": ("abc", None, {"a": 0.03, "b": 0.01, "c": 0.02}, 2),
    "prune_beyond_keep": ("abcd", {"a": 3.0, "b": 1.0, "c": 2.0, "d": 4.0},
                          {"a": 0.3, "b": 0.1, "c": 0.2, "d": 0.4}, 2),
    "keep_zero_measures_one": ("abc", {"a": 2.0, "b": 1.0, "c": 3.0},
                               {"a": 0.2, "b": 0.1, "c": 0.3}, 0),
    "overturned": ("ab", {"a": 2.0, "b": 1.0}, {"a": 0.01, "b": 0.05}, 2),
    "measure_error": ("ab", None, {"b": 0.02}, 2),
    "price_error_still_measured": ("ab", {"b": 1.0}, {"a": 0.01, "b": 0.05}, 1),
    "price_and_measure_error": ("abc", {"b": 1.0, "c": 2.0}, {"b": 0.3}, 3),
    "fallback_to_price": ("ab", {"a": 2.0, "b": 1.0}, {}, 2),
    "fallback_to_first": ("ab", {}, {}, 2),
    "fallback_to_first_unpriced": ("ba", None, {}, 2),
    "tie_keeps_order": ("abc", {"a": 1.0, "b": 1.0, "c": 1.0},
                        {"a": 0.1, "b": 0.1, "c": 0.1}, 2),
}


@pytest.mark.parametrize("name", sorted(SCENARIOS))
def test_sweep_decides_as_jax(name):
    from kubeflow_tpu.training import autotune as jauto

    keys, prices, times, keep = SCENARIOS[name]
    cands = [{"k": k} for k in keys]
    price, measure = _scripted(prices or {}, times)
    price = price if prices is not None else None
    want = jauto.sweep("t", cands, measure=measure, price=price, keep=keep)
    got = sweep("t", cands, measure=measure, price=price, keep=keep)
    assert got.chosen == want.chosen
    assert got.to_row() == want.to_row()
    assert got.to_dict() == want.to_dict()
    assert got.render() == want.render()


def test_resnet_quick_price_credits_the_fused_set():
    from kubeflow_tpu.training import autotune as jauto

    assert jauto.resnet_quick_candidates() == [{"fused_blocks": False}, {"fused_blocks": True}]
    result = autotune_resnet_quick(steps=1, device="cpu")
    est = {c.knobs["fused_blocks"]: c.est_seconds for c in result.candidates}
    assert est[True] == pytest.approx(0.7 * est[False])
    assert gpt_quick_candidates(8) == jauto.gpt_quick_candidates(8)
    assert gpt_quick_candidates(1) == jauto.gpt_quick_candidates(1)


def test_gpt_bench_price_prunes_remat():
    """bench.py's GPT grid, priced at a toy width: remat's recomputed
    forward costs more; scan_blocks changes nothing in the port (the
    Python loop over the blocks is the scan), so the port's grid drops
    that axis."""
    import dataclasses

    from kubeflow_tpu_torch.training.gpt import price_step, sweep_candidates, tiny_config

    cfg = tiny_config(32)
    assert sweep_candidates() == [{"remat": False}, {"remat": True}]
    est = {(sb, rm): price_step(dataclasses.replace(cfg, scan_blocks=sb, remat=rm), 2, 32)
           for sb in (True, False) for rm in (False, True)}
    assert est[(True, True)] > est[(True, False)] == est[(False, False)]
    assert est[(True, True)] == est[(False, True)]


def test_strict_sweep_raises_a_measure_error_and_keeps_price_errors():
    def measure(kn):
        if kn["k"] == "b":
            raise RuntimeError("no kernel image for the device")
        return 0.01

    def price(kn):
        if kn["k"] == "a":
            raise RuntimeError("unpriceable")
        return 1.0

    with pytest.raises(RuntimeError, match=r"autotune\[t\]: \{'k': 'b'\} failed to run: "
                                           "no kernel image"):
        sweep("t", [{"k": "a"}, {"k": "b"}], measure=measure, strict=True)
    result = sweep("t", [{"k": "a"}, {"k": "c"}], measure=measure, price=price, strict=True)
    assert result.chosen == {"k": "a"}
    assert result.candidates[0].error == "price: unpriceable"


def test_resnet_bench_sweep_raises_when_the_fused_candidate_fails(monkeypatch):
    """A fused kernel that fails to launch stops train(fused_blocks="auto");
    the sweep never trains on the unfused model in its place."""
    from kubeflow_tpu_torch.models import resnet as mresnet
    from kubeflow_tpu_torch.training import resnet

    def boom(*args, **kwargs):
        raise RuntimeError("fused_bottleneck: launch failed")

    monkeypatch.setattr(mresnet, "fused_transition_block", boom)
    with pytest.raises(RuntimeError, match=r"\{'fused_blocks': True\} failed to run: "
                                           "fused_bottleneck: launch failed"):
        resnet.train(resnet.tiny_config(), steps=1, device="cpu", fused_blocks="auto")


def test_gpt_bench_sweep_raises_when_the_measured_candidate_fails():
    from kubeflow_tpu_torch.training import gpt

    def boom(*args, **kwargs):
        raise RuntimeError("flash_fwd: launch failed")

    with pytest.raises(RuntimeError, match=r"\{'remat': False\} failed to run: flash_fwd"):
        gpt.train(gpt.tiny_config(32), batch=2, seq=32, steps=1, device="cpu", autotune=True,
                  attention_fn=boom)


# -- on the card --------------------------------------------------------------

@pytest.mark.cuda
def test_resnet_quick_sweep_on_the_card():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the fused candidate launches the fused-block kernels")
    from kubeflow_tpu_torch.ops import fused_bottleneck as fb

    fb.reset_launches()
    result = autotune_resnet_quick(steps=2, device="cuda")
    assert not any(c.error for c in result.candidates), result.render()
    assert all(c.measured_seconds > 0 for c in result.candidates)
    # the fused candidate's toy: two stage heads, a warm-up and 2 timed steps
    assert fb.LAUNCHES["fused_transition"] == 2 * 3
    assert fb.LAUNCHES["fused_bottleneck"] == 0
