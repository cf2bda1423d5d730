"""kubeflow_tpu_torch/hpo/{suggest,earlystop,study}.py against the JAX package's HPO.

The suggesters and the median rule are the port's copies of
``kubeflow_tpu/hpo/suggest.py`` and ``earlystop.py``: scripted tell/ask
sequences over ``e2e/studyjob_driver.py``'s parameter space give the same
asks, float for float, and the rule decides as JAX's on scripted and drawn
histories. The study loop (``hpo/study.py``) at ``parallel=1`` finds
JAX's ``run_studyjob_e2e`` optimum on the quadratic objective, and with
median stopping on a short MNIST trial it keeps JAX's accounting.
"""

import dataclasses
import functools

import pytest
from hypothesis import given, settings, strategies as st

from kubeflow_tpu.controllers.studyjob import param_specs_of as jax_param_specs_of
from kubeflow_tpu.hpo import earlystop as jes
from kubeflow_tpu.hpo.suggest import make_suggester as jax_make_suggester
from kubeflow_tpu_torch.hpo import earlystop as tes
from kubeflow_tpu_torch.hpo import study as tstudy
from kubeflow_tpu_torch.hpo.suggest import make_suggester
from kubeflow_tpu_torch.hpo.trials import mnist_objective, quadratic_objective


def _jax_cr(**kw):
    from e2e.studyjob_driver import studyjob_cr

    return studyjob_cr("study", "ns", kw.get("max_trials", 6), kw.get("parallel", 2),
                       kw.get("early_stopping", False))


def test_study_space_is_jaxs():
    cr = _jax_cr(early_stopping=True)
    assert tstudy.STUDY_PARAMETERS == cr["spec"]["parameters"]
    assert tstudy.EARLY_STOPPING == cr["spec"]["earlyStopping"]
    assert cr["spec"]["algorithm"]["algorithmName"] == "bayesian"
    assert cr["spec"]["objective"] == {"type": "maximize",
                                       "objectiveMetricName": tstudy.METRIC}
    assert ([dataclasses.asdict(p) for p in tstudy.param_specs_of(tstudy.STUDY_PARAMETERS)]
            == [dataclasses.asdict(p) for p in jax_param_specs_of(cr)])


#: (ask count, then tell each asked point's quadratic accuracy) rounds:
#: the Bayesian suggester passes its 4 random start-up asks by round 3
SCRIPT = (2, 3, 1, 4, 2)


@pytest.mark.parametrize("algorithm", ["random", "grid", "bayesian"])
@pytest.mark.parametrize("seed", [0, 1, 2])
def test_scripted_asks_equal_jax(algorithm, seed):
    specs = tstudy.param_specs_of(tstudy.STUDY_PARAMETERS)
    mine, jaxs = (make_suggester(algorithm, specs, True, seed=seed),
                  jax_make_suggester(algorithm, specs, True, seed=seed))
    asked = 0
    for count in SCRIPT:
        got, want = mine.ask(count), jaxs.ask(count)
        assert got == want
        asked += len(got)
        for params in got:
            value = quadratic_objective(params)["accuracy"]
            mine.tell(params, value)
            jaxs.tell(params, value)
    assert asked > 4 or algorithm == "grid"
    assert dataclasses.asdict(mine.best()) == dataclasses.asdict(jaxs.best())


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_rebuilt_suggester_asks_equal_jax(seed):
    """The study rebuilds its suggester at every decision point and tells it
    the finished trials; the rebuilt one asks as JAX's rebuilt one."""
    specs = tstudy.param_specs_of(tstudy.STUDY_PARAMETERS)
    history = []
    for _ in range(7):
        mine, jaxs = (make_suggester("bayesian", specs, True, seed=seed),
                      jax_make_suggester("bayesian", specs, True, seed=seed))
        for params, value in history:
            mine.tell(params, value)
            jaxs.tell(params, value)
        got = mine.ask(2)
        assert got == jaxs.ask(2)
        history += [(p, quadratic_objective(p)["accuracy"]) for p in got]


@pytest.mark.parametrize("spec", [
    {}, {"earlyStopping": None}, {"earlyStopping": {"algorithmName": "medianstop"}},
    {"earlyStopping": {"algorithmName": "medianstop", "settings": {"minTrials": 5}}},
    {"earlyStopping": {"algorithmName": "medianstop",
                       "settings": {"minTrials": "2", "minStep": "10"}}},
])
def test_parse_early_stopping_equals_jax(spec):
    assert tes.parse_early_stopping(spec) == jes.parse_early_stopping(spec)


def test_unknown_early_stopping_raises_as_jax():
    spec = {"earlyStopping": {"algorithmName": "hyperband"}}
    for mod in (tes, jes):
        with pytest.raises(ValueError, match="hyperband"):
            mod.parse_early_stopping(spec)


#: (current history, others) cases of the median rule, each read as JAX's
CASES = [
    ([], [[(1, 0.5)]] * 3),
    ([(0.5, 0.1)], [[(1, 0.9)]] * 3),              # before min_step
    ([(5, 0.1)], [[(5, 0.9)], [(5, 0.8)]]),        # fewer than min_trials others
    ([(5, 0.1)], [[(5, 0.9)], [(5, 0.8)], [(5, 0.7)]]),
    ([(5, 0.85)], [[(5, 0.9)], [(5, 0.8)], [(5, 0.7)]]),
    ([(5, 0.8)], [[(5, 0.9)], [(5, 0.8)], [(5, 0.7)]]),  # equal to the median: kept
    ([(5, 0.2), (10, 0.3)], [[(5, 0.1), (10, 0.9)], [(5, 0.4)], [(10, 0.6)], []]),
]


@pytest.mark.parametrize("current,others", CASES)
@pytest.mark.parametrize("maximize", [True, False])
def test_should_stop_scripted_equals_jax(current, others, maximize):
    assert (tes.should_stop(current, others, maximize=maximize)
            == jes.should_stop(current, others, maximize=maximize))


_history = st.lists(st.tuples(st.integers(0, 20).map(float),
                              st.floats(-10, 10, allow_nan=False)), max_size=6)


@settings(max_examples=200, deadline=None)
@given(current=_history, others=st.lists(_history, max_size=6), maximize=st.booleans(),
       min_trials=st.integers(1, 4), min_step=st.integers(0, 6),
       at=st.integers(0, 20).map(float))
def test_median_rule_drawn_equals_jax(current, others, maximize, min_trials, min_step, at):
    kw = dict(maximize=maximize, min_trials=min_trials, min_step=min_step)
    assert tes.should_stop(current, others, **kw) == jes.should_stop(current, others, **kw)
    assert tes.running_average_at(current, at) == jes.running_average_at(current, at)


@pytest.fixture(scope="module")
def quadratic_jax():
    from e2e.studyjob_driver import run_studyjob_e2e

    return run_studyjob_e2e("quadratic", 6, parallel=1)


def test_parallel_one_quadratic_optimum_equals_jax(quadratic_jax):
    status = tstudy.run_study("quadratic", max_trials=6, parallel=1, device="cpu")
    assert set(status) == set(quadratic_jax)
    assert status["currentOptimalTrial"] == quadratic_jax["currentOptimalTrial"]
    for key in ("phase", "trialsTotal", "trialsSucceeded", "trialsFailed", "trialsPruned",
                "goalReached"):
        assert status[key] == quadratic_jax[key], key
    assert status["trialsPerHour"] > 0


def test_median_stopping_study_on_mnist(quadratic_jax):
    """Four trials at once with median stopping, each a short MNIST run
    reporting at steps 5 and 10: every trial ends succeeded or pruned, and
    the optimum is the best accuracy any trial reported last (run_study
    raises otherwise, as run_studyjob_e2e does)."""
    objective = functools.partial(mnist_objective, steps=15, batch=16)
    status = tstudy.run_study(objective, max_trials=8, parallel=4, early_stopping=True,
                              device="cpu")
    assert set(status) == set(quadratic_jax)
    assert status["trialsSucceeded"] + status["trialsPruned"] == 8
    assert status["trialsTotal"] == 8 and status["trialsFailed"] == 0
    assert 0.0 <= status["currentOptimalTrial"]["observation"]["accuracy"] <= 1.0
    assert set(status["currentOptimalTrial"]["parameterAssignments"]) == {"lr", "width"}


def test_a_marked_trial_stops_at_its_next_report():
    """At ``parallel=1`` the trials run in turn: three report 0.9 at steps
    5, 10, 15; the fourth reports 0.1 at step 5, is marked by that report's
    pass, sees the mark at step 10 (JAX's runner reads the annotation
    before its own update) and ends pruned with its last metrics."""
    calls = []

    def objective(params, report_fn):
        value = 0.1 if len(calls) == 3 else 0.9
        calls.append([])
        for step in (5, 10, 15):
            calls[-1].append(step)
            if report_fn(step, {"accuracy": value}) is False:
                break
        return {"accuracy": value}

    status = tstudy.run_study(objective, max_trials=5, parallel=1, early_stopping=True,
                              device="cpu")
    assert calls == [[5, 10, 15]] * 3 + [[5, 10]] + [[5, 10, 15]]
    assert (status["trialsSucceeded"], status["trialsPruned"]) == (4, 1)
    assert status["currentOptimalTrial"]["observation"]["accuracy"] == 0.9


def test_failed_trials_fail_the_study_as_jaxs_driver():
    def objective(params):
        raise RuntimeError("trial broke")

    with pytest.raises(AssertionError, match="trial broke"):
        tstudy.run_study(objective, max_trials=3, parallel=2, device="cpu")


def test_grid_study_ends_when_the_grid_does():
    """A grid of 4 x 4 points under a budget of 40: the study completes
    when the grid is exhausted (run_study would then raise, as JAX's driver
    does for a study that ran fewer trials than its budget)."""
    study = tstudy.Study(quadratic_objective, max_trials=40, parallel=3, early_stopping=False,
                         algorithm="grid", parameters=tstudy.STUDY_PARAMETERS, seed=0)
    with study.lock:
        study.reconcile()
    status = study.wait(60)
    assert status["reason"] == "SearchSpaceExhausted"
    assert status["trialsTotal"] == status["trialsSucceeded"] == 16


def test_device_and_algorithm_are_checked():
    import torch

    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="CUDA"):
            tstudy.run_study("quadratic", max_trials=1, parallel=1)
    with pytest.raises(ValueError, match="unknown algorithm"):
        tstudy.run_study("quadratic", max_trials=1, parallel=1, algorithm="tpe", device="cpu")


def test_many_threads_keep_the_accounting():
    """More trial threads than cores, a short switch interval: every trial
    is created once, counted once and ends succeeded or pruned."""
    import os
    import sys

    def objective(params, report_fn):
        value = quadratic_objective(params)["accuracy"]
        for step in range(1, 6):
            if report_fn(step, {"accuracy": value * step / 5}) is False:
                break
        return {"accuracy": value}

    parallel = min(32, 2 * (os.cpu_count() or 4))
    old = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        status = tstudy.run_study(objective, max_trials=3 * parallel, parallel=parallel,
                                  early_stopping=True, timeout=60, device="cpu")
    finally:
        sys.setswitchinterval(old)
    assert status["trialsTotal"] == 3 * parallel
    assert status["trialsSucceeded"] + status["trialsPruned"] == 3 * parallel
    assert status["trialsFailed"] == 0
