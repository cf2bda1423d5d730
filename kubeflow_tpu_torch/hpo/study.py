"""An in-process hyperparameter study: the StudyJob loop without the control plane.

The trimmed counterpart of three pieces of the JAX package:

- the StudyJob reconciler's decisions (``kubeflow_tpu/controllers/
  studyjob.py`` ``StudyJobReconciler.reconcile``): at every decision point
  a fresh suggester (the study's seed) is told every succeeded trial and
  then every pruned one, each in trial-index order (JAX lists its Trial
  objects in creation order), the median rule runs over the active trials,
  and ``min(parallel - active, budget_left)`` new trials are asked for;
- its in-process trial runner's ``report_fn``: an objective that takes
  ``report_fn`` reports intermediate metrics, each report is a decision
  point, and the report returns False once an earlier pass marked the
  trial (JAX's ``early-stop`` annotation), so the objective stops and the
  trial ends ``Pruned``;
- ``e2e/studyjob_driver.py`` ``run_studyjob_e2e``: JAX's parameter space
  (:data:`STUDY_PARAMETERS`), its median-stop settings, its checks on the
  completed study and its ``elapsedSeconds`` and ``trialsPerHour``.

Trials run on threads of one process, up to ``parallel`` at once, on one
device. The apiserver, the Trial and StudyJob objects and the controller
manager are control plane and are not ported; a decision point here is
what a reconcile is there, run under one lock.
"""

from __future__ import annotations

import inspect
import threading
import time
from dataclasses import dataclass, field
from typing import Any, Callable, Dict, List, Optional, Sequence, Tuple, Union

from ..device import DeviceLike, resolve_device
from . import earlystop
from .suggest import GridSuggester, ParamSpec, make_suggester
from .trials import mnist_objective, quadratic_objective

OBJECTIVES = {"quadratic": quadratic_objective, "mnist": mnist_objective}
#: the study's objective (``studyjob_cr``): maximize ``accuracy``
METRIC = "accuracy"

#: ``studyjob_cr``'s ``spec.parameters``: lr in [1e-4, 1] on a log scale,
#: width an int in [8, 64]
STUDY_PARAMETERS: List[Dict[str, Any]] = [
    {"name": "lr", "parameterType": "double",
     "feasibleSpace": {"min": "1e-4", "max": "1.0", "logScale": True}},
    {"name": "width", "parameterType": "int",
     "feasibleSpace": {"min": "8", "max": "64"}},
]

#: ``studyjob_cr``'s ``earlyStopping`` block when early stopping is on
EARLY_STOPPING = {"algorithmName": "medianstop", "settings": {"minTrials": 3}}

Objective = Callable[..., Dict[str, float]]


def param_specs_of(parameters: Sequence[Dict[str, Any]]) -> List[ParamSpec]:
    """StudyJob ``spec.parameters`` entries -> :class:`ParamSpec` (the
    reconciler's ``param_specs_of``)."""
    specs = []
    for p in parameters:
        feasible = p.get("feasibleSpace") or {}
        specs.append(ParamSpec(
            name=p["name"], type=p.get("parameterType", "double"),
            min=None if feasible.get("min") is None else float(feasible["min"]),
            max=None if feasible.get("max") is None else float(feasible["max"]),
            values=feasible.get("list") or (), log_scale=bool(feasible.get("logScale"))))
    if not specs:
        raise ValueError("study has no parameters")
    return specs


@dataclass
class Trial:
    index: int
    params: Dict[str, Any]
    #: Running, then Succeeded, Pruned or Failed
    phase: str = "Running"
    metrics: Optional[Dict[str, float]] = None
    #: intermediate reports: (step, value of :data:`METRIC`)
    observations: List[Tuple[float, float]] = field(default_factory=list)
    #: set by the median rule; the trial sees it at its next report
    marked: bool = False
    message: str = ""


class Study:
    """One study's state and its decision point (:meth:`reconcile`), which
    callers run under :attr:`lock`."""

    def __init__(self, objective: Objective, *, max_trials: int, parallel: int,
                 early_stopping: bool, algorithm: str, parameters: Sequence[Dict[str, Any]],
                 seed: int) -> None:
        self.objective = objective
        self.specs = param_specs_of(parameters)
        self.max_trials, self.parallel = int(max_trials), int(parallel)
        self.early = earlystop.parse_early_stopping(
            {"earlyStopping": EARLY_STOPPING} if early_stopping else {})
        self.algorithm, self.seed = algorithm, seed
        make_suggester(algorithm, self.specs, True, seed=seed)  # an unknown name raises here
        try:
            self.arguments = set(inspect.signature(objective).parameters)
        except (TypeError, ValueError):
            self.arguments = set()
        #: keyword arguments every trial's call gets (``run_study``'s device)
        self.bound: Dict[str, Any] = {}
        self.trials: List[Trial] = []
        self.status: Optional[Dict[str, Any]] = None
        self.lock = threading.Condition()
        self._threads: List[threading.Thread] = []

    def reconcile(self) -> None:
        if self.status is not None:
            return
        suggester = make_suggester(self.algorithm, self.specs, True, seed=self.seed)
        completed = [t for t in self.trials if t.phase == "Succeeded"]
        failed = [t for t in self.trials if t.phase == "Failed"]
        pruned = [t for t in self.trials if t.phase == "Pruned"]
        active = [t for t in self.trials if t.phase == "Running"]
        # pruned trials are told too: their last metrics are a real
        # (censored) measurement
        for t in completed + pruned:
            value = (t.metrics or {}).get(METRIC)
            if value is not None:
                suggester.tell(t.params, float(value))
        if self.early is not None and active:
            self._apply_median_stopping(active, completed)
        best = suggester.best()
        done = len(completed) + len(failed) + len(pruned)
        exhausted = False
        if isinstance(suggester, GridSuggester):
            # past every point a trial was created for; an exhausted grid
            # completes the study once the running trials finish
            suggester.ask(len(self.trials))
            exhausted = suggester.exhausted
        if (done >= self.max_trials or exhausted) and not active:
            # a study here sets no goal (studyjob_cr sets none), so it is never reached
            status = {"phase": "Completed", "trialsTotal": len(self.trials),
                      "trialsSucceeded": len(completed), "trialsFailed": len(failed),
                      "trialsPruned": len(pruned), "goalReached": False}
            if exhausted and done < self.max_trials:
                status["reason"] = "SearchSpaceExhausted"
            if best:
                status["currentOptimalTrial"] = {"parameterAssignments": best.params,
                                                 "observation": {METRIC: best.objective}}
            self.status = status
            self.lock.notify_all()
            return
        budget_left = self.max_trials - done - len(active)
        want_new = max(0, min(self.parallel - len(active), budget_left))
        if want_new:
            for params in suggester.ask(want_new):
                self._start(params)

    def _apply_median_stopping(self, active: List[Trial], completed: List[Trial]) -> None:
        histories = {t.index: t.observations for t in active + completed}
        for t in active:
            if t.marked:
                continue
            others = [h for i, h in histories.items() if i != t.index and h]
            if earlystop.should_stop(list(t.observations), others, maximize=True,
                                     min_trials=self.early["min_trials"],
                                     min_step=self.early["min_step"]):
                t.marked = True

    def _start(self, params: Dict[str, Any]) -> None:
        trial = Trial(index=len(self.trials), params=params)
        self.trials.append(trial)
        thread = threading.Thread(target=self._run, args=(trial,), daemon=True,
                                  name=f"study-trial-{trial.index}")
        self._threads.append(thread)
        thread.start()

    def _report(self, trial: Trial, step: float, metrics: Dict[str, float]) -> bool:
        with self.lock:
            # the mark from an earlier report's pass, read before this one's
            stopped = trial.marked
            value = metrics.get(METRIC)
            if value is not None:
                trial.observations.append((float(step), float(value)))
            self.reconcile()
        return not stopped

    def _run(self, trial: Trial) -> None:
        try:
            kw = dict(self.bound)
            if "report_fn" in self.arguments:
                kw["report_fn"] = lambda step, m: self._report(trial, step, m)
            metrics = self.objective(trial.params, **kw)
            with self.lock:
                trial.metrics = metrics
                trial.phase = "Pruned" if trial.marked else "Succeeded"
        except Exception as e:  # a failed trial is data, as in JAX's runner
            with self.lock:
                trial.phase, trial.message = "Failed", str(e)
        with self.lock:
            self.reconcile()

    def wait(self, timeout: float) -> Dict[str, Any]:
        deadline = time.monotonic() + timeout
        with self.lock:
            while self.status is None:
                left = deadline - time.monotonic()
                if left <= 0:
                    running = [t.index for t in self.trials if t.phase == "Running"]
                    raise TimeoutError(f"study not completed in {timeout} s "
                                       f"(trials still running: {running})")
                self.lock.wait(left)
        for thread in self._threads:
            thread.join()
        return dict(self.status)


def run_study(objective: Union[str, Objective] = "quadratic", *, max_trials: int = 6,
              parallel: int = 2, early_stopping: bool = False, algorithm: str = "bayesian",
              params: Sequence[Dict[str, Any]] = STUDY_PARAMETERS, seed: int = 0,
              timeout: float = 900.0,
              device: DeviceLike = "cuda") -> Dict[str, Any]:
    """Run a study to completion and return its final status, with JAX's
    keys: ``phase``, ``trialsTotal``, ``trialsSucceeded``,
    ``trialsFailed``, ``trialsPruned``, ``goalReached``,
    ``currentOptimalTrial`` (``parameterAssignments`` and
    ``observation``), ``elapsedSeconds`` and ``trialsPerHour``.

    ``objective`` is a name in :data:`OBJECTIVES` or a callable
    ``(params[, report_fn=...][, device=...]) -> {metric: value}``; one
    that takes ``device`` gets ``device`` (``mnist_objective`` trains on
    it). ``params`` are StudyJob ``spec.parameters`` entries (JAX's
    ``studyjob_cr`` space by default). As ``run_studyjob_e2e`` does, it
    raises unless every trial succeeded or was pruned and the optimum is
    the best observed accuracy."""
    dev = resolve_device(device)
    fn = OBJECTIVES[objective] if isinstance(objective, str) else objective
    study = Study(fn, max_trials=max_trials, parallel=parallel,
                  early_stopping=early_stopping, algorithm=algorithm, parameters=params,
                  seed=seed)
    if "device" in study.arguments:
        study.bound["device"] = dev
    t_start = time.perf_counter()
    with study.lock:
        study.reconcile()
    status = study.wait(timeout)
    finished = status["trialsSucceeded"] + status["trialsPruned"]
    failed = {t.index: t.message for t in study.trials if t.phase == "Failed"}
    if finished != max_trials or len(study.trials) != max_trials:
        raise AssertionError(f"study {status}: {len(study.trials)} trials, failed {failed}")
    optimal = status.get("currentOptimalTrial")
    if not optimal:
        raise AssertionError("completed study published no optimal trial")
    best = optimal["observation"][METRIC]
    observed = [t.metrics.get(METRIC) for t in study.trials if t.metrics]
    observed = [v for v in observed if v is not None]
    if abs(best - max(observed)) >= 1e-9:
        raise AssertionError(f"optimum {best} is not the best observed {max(observed)}")
    elapsed = time.perf_counter() - t_start
    status["elapsedSeconds"] = round(elapsed, 3)
    status["trialsPerHour"] = round(max_trials / elapsed * 3600.0, 1)
    return status
