"""kubeflow_tpu_torch/bench.py against the root bench.py, on the CPU.

The helpers are held to JAX's on scripted inputs: the batch ladder, the
per-step breakdown of a stub clock's summary and the timed windows under a
scripted clock. The ResNet and GPT rows run at ``training/resnet.py`` and
``training/gpt.py`` ``tiny_config()`` (2 steps, 2 windows) and JAX's
``_run_resnet`` / ``_run_gpt`` build their rows from the port's raw
result: the two rows hold the same keys and values (``vs_baseline`` is
None in the port's). ``serving_row`` is held to JAX's ``_run_serving`` on
the serving probe's rows at its CPU test sizes; ``main``'s summary line to
JAX's. The multichip row is in ``tests/test_torch_bench_multichip.py``.
"""

import json

import pytest
import torch

import bench as jbench
from kubeflow_tpu_torch import bench as tb
from kubeflow_tpu_torch.e2e import serving_bench as sb
from kubeflow_tpu_torch.training import gpt, resnet

torch.set_num_threads(1)


def _without(row, *keys):
    return {k: v for k, v in row.items() if k not in keys}


# -- helpers ------------------------------------------------------------------

def test_batch_candidates_equal_jax(monkeypatch):
    monkeypatch.delenv("BENCH_BATCH", raising=False)
    assert tb._batch_candidates() == jbench._batch_candidates() == [256, 512, 128, 64, 32]
    monkeypatch.setenv("BENCH_BATCH", "64")
    assert tb._batch_candidates(64) == jbench._batch_candidates() == [64]


class _StubClock:
    def __init__(self, phases):
        self.phases = phases

    def summary(self):
        return dict(self.phases)


@pytest.mark.parametrize("phases", [
    {},
    {"compile_s": 12.3456789, "compute": 2.5, "fetch": 0.001234567, "other": 0.25},
    {"compile_s": 0.0004, "data_wait": 0.75, "compute": 11.0, "fetch": 3e-7,
     "other": 1.0 / 3, "total": 13.0, "steps": 3.0},
])
@pytest.mark.parametrize("timed_steps", [1, 4, 50])
def test_step_breakdown_equals_jax(phases, timed_steps):
    clock = _StubClock(phases)
    assert tb.step_breakdown(clock, timed_steps) == jbench._step_breakdown(clock, timed_steps)


class _Ticks:
    """A ``time`` module whose ``perf_counter`` reads a script."""

    def __init__(self, ticks):
        self._ticks = iter(ticks)

    def perf_counter(self):
        return next(self._ticks)


@pytest.mark.parametrize("ticks,repeats", [
    ([0.0, 1.5, 2.0, 2.25, 3.0, 7.0], 3),
    ([10.0, 10.5, 11.0, 12.0], 2),
    ([0.0, 0.125], 1),
])
def test_timed_windows_equal_jax(monkeypatch, ticks, repeats):
    out = {}
    for name, mod in (("port", tb), ("jax", jbench)):
        monkeypatch.setattr(mod, "time", _Ticks(ticks))
        calls = []

        def window():
            calls.append("window")

        window.check = lambda: calls.append("check")
        out[name] = (mod._timed_windows(window, repeats), calls)
    assert out["port"] == out["jax"]
    assert out["port"][1] == ["window", "check"] * repeats


def test_a_failed_check_stops_the_windows_as_jax(monkeypatch):
    for mod in (tb, jbench):
        monkeypatch.setattr(mod, "time", _Ticks([0.0, 1.0, 2.0, 3.0]))
        runs = []

        def window():
            runs.append(1)

        def check():
            raise RuntimeError("non-finite bench result")

        window.check = check
        with pytest.raises(RuntimeError, match="non-finite"):
            mod._timed_windows(window, 3)
        assert runs == [1]


# -- the ResNet and GPT rows -----------------------------------------------------

STEPS, REPEATS = 2, 2


def _observed(run, **kw):
    seen = {}
    row = run(timed_steps=STEPS, repeats=REPEATS, device="cpu",
              observe=lambda stage, info: seen.setdefault(stage, info), **kw)
    return row, seen


@pytest.fixture(scope="module")
def resnet_run():
    return _observed(tb.run_resnet, cfg=resnet.tiny_config())


@pytest.fixture(scope="module")
def gpt_run():
    return _observed(tb.run_gpt, cfg=gpt.tiny_config(gpt.TINY_SEQ), batch=gpt.TINY_BATCH,
                     seq=gpt.TINY_SEQ)


def test_resnet_row_equals_jaxs(resnet_run, monkeypatch):
    row, seen = resnet_run
    raw = seen["run"]["result"]
    monkeypatch.setattr(jbench, "_batch_candidates", lambda: [raw["batch"]])
    monkeypatch.setattr(jbench, "_bench", lambda batch: raw)
    want = jbench._run_resnet("cpu")
    assert set(row) == set(want)
    assert _without(row, "vs_baseline") == _without(want, "vs_baseline")
    assert row["vs_baseline"] is None
    assert row["metric"] == "resnet50_train_mfu_h100_1chip" and row["platform"] == "cpu"


def test_gpt_row_equals_jaxs(gpt_run, monkeypatch):
    row, seen = gpt_run
    raw = seen["run"]["result"]
    monkeypatch.setattr(jbench, "_bench_gpt", lambda batch, seq: raw)
    want = jbench._run_gpt("cpu")
    assert set(row) == set(want)
    assert _without(row, "vs_baseline") == _without(want, "vs_baseline")
    assert row["vs_baseline"] is None
    assert row["metric"] == "gpt2_medium_train_mfu_h100_1chip" and row["platform"] == "cpu"
    assert (row["batch"], row["seq"]) == (gpt.TINY_BATCH, gpt.TINY_SEQ)


@pytest.mark.parametrize("which", ["resnet", "gpt"])
def test_windows_start_from_one_state(which, resnet_run, gpt_run):
    """Each window restarts from the initial model and optimizer state, as
    JAX's functional window does: on the CPU both windows' last losses are
    equal in f32, and there is one window mfu a repeat."""
    row, seen = {"resnet": resnet_run, "gpt": gpt_run}[which]
    raw = seen["run"]["result"]
    assert len(raw["window_losses"]) == REPEATS == len(row["window_mfus"])
    assert raw["window_losses"][0] == raw["window_losses"][1]
    assert raw["window_losses"][0] > 0


def test_resnet_sweep_and_attribution(resnet_run):
    row, seen = resnet_run
    assert row["autotune"]["swept"] == row["autotune"]["measured"] == 2
    assert set(row["fused_calibration"]) == {"fused", "unfused"}
    assert row["fused_blocks"] == seen["sweep"]["result"].chosen["fused_blocks"]
    attr = row["attribution"]
    assert "error" not in attr and abs(sum(attr["fractions"].values()) - 1.0) < 1e-3
    assert attr["coverage"]["total"] == 4  # two stages of two bottlenecks
    assert set(row["step_breakdown"]) == set(jbench._step_breakdown(_StubClock({}), 1))
    assert row["step_breakdown"]["device_compute_s_per_step"] > 0
    assert row["peak_hbm_bytes"] is None  # no device counter on the CPU


def test_gpt_sweep_and_attribution(gpt_run):
    row, seen = gpt_run
    a = row["autotune"]
    assert (a["swept"], a["measured"], a["pruned"]) == (2, 1, 1)
    assert row["remat"] == seen["sweep"]["result"].chosen["remat"]
    assert "error" not in row["attribution"]
    assert abs(sum(row["attribution"]["fractions"].values()) - 1.0) < 1e-3
    raw = seen["run"]["result"]
    assert raw["flops_per_step"] > gpt.causal_attention_flops(
        gpt.tiny_config(gpt.TINY_SEQ), gpt.TINY_BATCH, gpt.TINY_SEQ)


@pytest.mark.parametrize("family", ["resnet", "gpt"])
def test_bench_and_train_share_one_setup(family, monkeypatch):
    """The bench's rows and ``train()`` set up through one ``prepare``: with
    the sweep on, both call it, and from one seed they count the same
    FLOPs and sweep the same candidates."""
    mod = {"resnet": resnet, "gpt": gpt}[family]
    calls = []
    prepare = mod.prepare

    def spy(*args, **kw):
        calls.append(kw)
        return prepare(*args, **kw)

    monkeypatch.setattr(mod, "prepare", spy)
    if family == "resnet":
        trained = resnet.train(resnet.tiny_config(), steps=1, device="cpu",
                               fused_blocks="auto")
        benched = tb._bench_resnet(resnet.tiny_config(), timed_steps=1, repeats=1,
                                   attribution=False, device="cpu")
        assert [c["fused_blocks"] for c in calls] == ["auto", "auto"]
    else:
        cfg = gpt.tiny_config(gpt.TINY_SEQ)
        trained = gpt.train(cfg, batch=gpt.TINY_BATCH, seq=gpt.TINY_SEQ, steps=1,
                            device="cpu", autotune=True)
        benched = tb._bench_gpt(cfg, gpt.TINY_BATCH, gpt.TINY_SEQ, timed_steps=1, repeats=1,
                                attribution=False, device="cpu")
        assert [c["autotune"] for c in calls] == [True, True]
    assert trained["flops_per_step"] == benched["flops_per_step"]
    keys = ("family", "swept", "pruned", "measured", "errors")
    assert [trained["autotune"][k] for k in keys] == [benched["autotune"][k] for k in keys]


def test_pinned_rows():
    row = tb.run_gpt(cfg=gpt.tiny_config(gpt.TINY_SEQ), batch=gpt.TINY_BATCH,
                     seq=gpt.TINY_SEQ, timed_steps=1, repeats=1, remat=True,
                     attribution=False, device="cpu")
    assert row["autotune"] == {"family": "gpt", "chosen": {"remat": True},
                               "pinned": "remat=True"}
    assert row["remat"] is True and row["attribution"] is None


def test_batch_ladder_steps_down_on_oom_only(monkeypatch):
    tried = []

    def bench_oom(cfg, **kw):
        tried.append(cfg.batch)
        if cfg.batch > 128:
            raise torch.OutOfMemoryError("CUDA out of memory")
        raise ValueError("not a memory error")

    monkeypatch.setattr(tb, "_bench_resnet", bench_oom)
    row = tb.run_resnet(device="cpu")
    assert tried == [256, 512, 128]
    assert row == {"metric": "resnet50_train_mfu", "value": 0.0, "unit": "percent_mfu",
                   "vs_baseline": None, "error": "not a memory error"}
    tried.clear()

    def always_oom(cfg, **kw):
        tried.append(cfg.batch)
        raise torch.OutOfMemoryError("oom")

    monkeypatch.setattr(tb, "_bench_resnet", always_oom)
    row = tb.run_resnet(device="cpu")
    assert tried == [256, 512, 128, 64, 32] and row["error"] == "oom"


def test_entry_points_need_cuda_unless_asked():
    if torch.cuda.is_available():
        pytest.skip("a card is present: the default device is valid")
    for run in (tb.run_resnet, tb.run_gpt, tb.run_serving, tb.run_hpo, tb.run_multichip):
        with pytest.raises(RuntimeError, match="CUDA"):
            run()


# -- the serving row ------------------------------------------------------------

@pytest.fixture(scope="module")
def serving_rows():
    """The serving probe's four passes at its CPU test sizes."""
    d = tb._tiny_serving()
    return (sb.bench_bert_http(device="cpu", **d["bert"]),
            sb.bench_gpt_decode(device="cpu", **d["decode"]),
            sb.bench_continuous(device="cpu", **d["continuous"]),
            sb.bench_disagg(device="cpu", **d["disagg"]))


def _patch_jax_serving(monkeypatch, bert, decode, cont, disagg):
    import e2e.serving_bench as jsb

    monkeypatch.setattr(jsb, "bench_bert_http", lambda: bert)
    monkeypatch.setattr(jsb, "bench_gpt_decode", lambda: decode)
    monkeypatch.setattr(jsb, "bench_continuous", lambda: cont)
    monkeypatch.setattr(jsb, "bench_disagg", lambda: disagg)


@pytest.mark.parametrize("cont_on,disagg_on,b8", [
    (True, True, True), (False, False, True), (True, False, False)])
def test_serving_row_equals_jaxs(serving_rows, monkeypatch, cont_on, disagg_on, b8):
    bert, decode, cont, disagg = serving_rows
    if not b8:  # no batch-8 row: both take the last
        bert, decode = bert[:1], decode[:1]
    _patch_jax_serving(monkeypatch, bert, decode, cont, disagg)
    monkeypatch.setenv("BENCH_CONTINUOUS", "1" if cont_on else "0")
    monkeypatch.setenv("BENCH_DISAGG", "1" if disagg_on else "0")
    want = jbench._run_serving("cpu")
    row = tb.serving_row(bert, decode, cont if cont_on else None,
                         disagg if disagg_on else None, "cpu")
    assert "error" not in want
    assert set(row) == set(want)
    assert _without(row, "vs_baseline") == _without(want, "vs_baseline")
    assert row["vs_baseline"] is None


def test_run_serving_assembles_the_four_passes(serving_rows, monkeypatch):
    bert, decode, cont, disagg = serving_rows
    calls = []

    def patched(name, value):
        def call(**kw):
            calls.append((name, kw.pop("device").type, kw))
            return value
        monkeypatch.setattr(sb, name, call)

    patched("bench_bert_http", bert)
    patched("bench_gpt_decode", decode)
    patched("bench_continuous", cont)
    patched("bench_disagg", disagg)
    row = tb.run_serving(device="cpu", depths={"decode": {"new_tokens": 3}})
    assert row == tb.serving_row(bert, decode, cont, disagg, "cpu")
    assert calls == [("bench_bert_http", "cpu", {}), ("bench_gpt_decode", "cpu",
                                                      {"new_tokens": 3}),
                     ("bench_continuous", "cpu", {}), ("bench_disagg", "cpu", {})]
    calls.clear()
    tb.run_serving(continuous=False, disagg=False, device="cpu")
    assert [c[0] for c in calls] == ["bench_bert_http", "bench_gpt_decode"]


def test_serving_error_row_keeps_jax_keys(monkeypatch):
    import e2e.serving_bench as jsb

    def broken(*a, **k):
        raise RuntimeError("engine closed")

    monkeypatch.setattr(jsb, "bench_bert_http", broken)
    monkeypatch.setattr(sb, "bench_bert_http", broken)
    want, row = jbench._run_serving("cpu"), tb.run_serving(device="cpu")
    assert set(row) == set(want) and row["error"] == want["error"] == "engine closed"
    assert row["value"] == 0.0 and row["vs_baseline"] is None


# -- main -----------------------------------------------------------------------

STUB_ROWS = {
    "resnet": {"metric": "resnet50_train_mfu_h100_1chip", "value": 2.5, "unit": "percent_mfu",
               "vs_baseline": None, "images_per_sec_per_chip": 1000.0},
    "gpt": {"metric": "gpt2_medium_train_mfu_h100_1chip", "value": 9.5,
            "unit": "percent_mfu", "vs_baseline": None, "tokens_per_sec_per_chip": 40000.0},
    "serving": {"metric": "serving_gpt_kv_decode_tokens_per_sec_b8", "value": 150.0,
                "bert_http_p50_ms_b8": 20.0, "ttft_p99": 2.0, "spec_accept_rate": 0.01,
                "decode_tok_s_heterogeneous": 12.0, "kv_handoff_p99_s": 0.2},
    "hpo": {"metric": "hpo_mnist_trials_per_hour", "value": 3000.0},
    "multichip": {"metric": "multichip_composite_tokens_per_sec_per_chip_8dev",
                  "value": 10.0, "scaling_efficiency": 0.5},
}


def _stub_port(monkeypatch, rows):
    for name, row in rows.items():
        monkeypatch.setattr(tb, f"run_{name}", lambda *a, _row=row, **k: dict(_row))


def _lines(capsys):
    return [json.loads(line) for line in capsys.readouterr().out.splitlines() if line]


def test_main_summary_equals_jaxs(monkeypatch, capsys):
    _stub_port(monkeypatch, STUB_ROWS)
    assert tb.main(["--device", "cpu"]) == 0
    lines = _lines(capsys)
    assert lines[:-1] == [STUB_ROWS[k] for k in ("resnet", "gpt", "serving", "hpo")]
    summary = lines[-1]
    for name, row in STUB_ROWS.items():
        monkeypatch.setattr(jbench, f"_run_{name}", lambda *a, _row=row, **k: dict(_row))
    monkeypatch.delenv("BENCH_MODEL", raising=False)
    monkeypatch.delenv("BENCH_SKIP", raising=False)
    assert jbench.main() == 0
    want = _lines(capsys)[-1]
    assert set(summary) == set(want)
    # JAX's CPU test world has 8 devices, so its suite adds the multichip row;
    # the port's adds it where more than one card is visible
    skip = ("vs_baseline", "multichip_tokens_per_sec_per_chip", "multichip_scaling_efficiency")
    assert _without(summary, *skip) == _without(want, *skip)
    assert summary["platform"] == "cpu" and summary["errors"] is None
    assert summary["multichip_tokens_per_sec_per_chip"] is None


def test_an_error_row_exits_1(monkeypatch, capsys):
    rows = dict(STUB_ROWS, hpo={"metric": "hpo_mnist_trials_per_hour", "value": 0.0,
                                "unit": "trials_per_hour", "vs_baseline": None,
                                "error": "study timed out"})
    _stub_port(monkeypatch, rows)
    assert tb.main(["--device", "cpu"]) == 1
    assert _lines(capsys)[-1]["errors"] == {"hpo": "study timed out"}
    assert tb.main(["--device", "cpu", "--model", "hpo"]) == 1
    assert tb.main(["--device", "cpu", "--model", "gpt"]) == 0
    assert _lines(capsys) == [rows["hpo"], rows["gpt"]]


def test_skip_drops_a_row(monkeypatch, capsys):
    _stub_port(monkeypatch, STUB_ROWS)
    assert tb.main(["--device", "cpu", "--skip", "gpt,hpo"]) == 0
    lines = _lines(capsys)
    assert [r["metric"] for r in lines[:-1]] == [STUB_ROWS["resnet"]["metric"],
                                                 STUB_ROWS["serving"]["metric"]]
    assert lines[-1]["gpt2_medium_mfu_pct"] is None and lines[-1]["hpo_trials_per_hour"] is None


STUDY_STATUS = {"phase": "Completed", "trialsTotal": 16, "trialsSucceeded": 13,
                "trialsFailed": 0, "trialsPruned": 3, "goalReached": False,
                "currentOptimalTrial": {"parameterAssignments": {"lr": 0.01, "width": 40},
                                        "observation": {"accuracy": 0.96875}},
                "elapsedSeconds": 2.5, "trialsPerHour": 23040.0}


def _jax_hpo_row(monkeypatch):
    import e2e.studyjob_driver as jdriver

    monkeypatch.setattr(jdriver, "run_studyjob_e2e", lambda *a, **k: dict(STUDY_STATUS))
    monkeypatch.delenv("BENCH_HPO_TRIALS", raising=False)
    return jbench._run_hpo("cpu")


def test_hpo_row_equals_jaxs(monkeypatch):
    """JAX's ``_run_hpo`` and the port's ``run_hpo`` on the same study status."""
    from kubeflow_tpu_torch.hpo import study

    monkeypatch.setattr(study, "run_study", lambda *a, **k: dict(STUDY_STATUS))
    want, row = _jax_hpo_row(monkeypatch), tb.run_hpo(device="cpu")
    assert set(row) == set(want)
    assert _without(row, "vs_baseline") == _without(want, "vs_baseline")


def test_card_check_holds_jaxs_row_keys(resnet_run, gpt_run, serving_rows, monkeypatch):
    """``chip_smoke.py``'s ``BENCH_ROW_KEYS`` are the keys of JAX's rows."""
    import chip_smoke

    _patch_jax_serving(monkeypatch, *serving_rows)
    raw = {"n_devices": 2, "tokens_per_sec_per_chip": 1.0, "scaling_efficiency": None,
           "tokens_per_sec_1chip": None, "mesh": {}, "virtual_stages": 1,
           "gather_mode": "eager", "num_micro": 2, "microbatch": 2, "bubble_fraction": 0.5,
           "bubble_fraction_gpipe": 0.5, "comm_bytes_per_step": {}, "loss": 1.0,
           "step_breakdown": {}}
    monkeypatch.setattr(jbench, "_bench_multichip", lambda: raw)
    assert chip_smoke.BENCH_ROW_KEYS == {
        "resnet": set(resnet_run[0]), "gpt": set(gpt_run[0]),
        "serving": set(jbench._run_serving("cpu")), "hpo": set(_jax_hpo_row(monkeypatch)),
        "multichip": set(jbench._run_multichip("cpu"))}
