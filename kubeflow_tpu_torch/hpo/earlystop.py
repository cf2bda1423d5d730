"""Early stopping for a study: Katib's median stopping rule.

The port's own copy of ``kubeflow_tpu/hpo/earlystop.py`` (the standard
library only). Median stopping rule (Google Vizier §3.2 semantics): stop
trial T at step s when T's best objective so far is strictly worse than
the MEDIAN of the running averages (up to step s) of the other trials'
observation histories. Mild and model-free: a trial is only cut when half
the field was already better on average at the same depth.

The study loop (``hpo/study.py``) applies :func:`should_stop` at every
intermediate report and marks the losers; a trial sees its mark at its
next report and exits with its last metrics, as JAX's trial runner does
with the ``early-stop`` annotation.
"""

from __future__ import annotations

import statistics
from typing import Any, Dict, Optional, Sequence, Tuple

#: the rule's defaults: at least this many other trials, from this step on
MIN_TRIALS = 3
MIN_STEP = 1

Observation = Tuple[float, float]  # (step, value)


def parse_early_stopping(spec: Dict[str, Any]) -> Optional[Dict[str, Any]]:
    """``spec.earlyStopping`` -> settings dict or None (disabled).

    Shape (Katib's earlyStopping block):
        earlyStopping:
          algorithmName: medianstop
          settings: {minTrials: 3, minStep: 1}
    """
    es = spec.get("earlyStopping") or {}
    algo = es.get("algorithmName")
    if not algo:
        return None
    if algo != "medianstop":
        raise ValueError(f"unknown earlyStopping algorithm {algo!r} (have: medianstop)")
    settings = es.get("settings") or {}
    return {
        "min_trials": int(settings.get("minTrials", MIN_TRIALS)),
        "min_step": float(settings.get("minStep", MIN_STEP)),
    }


def running_average_at(history: Sequence[Observation], step: float) -> Optional[float]:
    vals = [v for s, v in history if s <= step]
    return sum(vals) / len(vals) if vals else None


def should_stop(
    current: Sequence[Observation],
    others: Sequence[Sequence[Observation]],
    *,
    maximize: bool,
    min_trials: int = MIN_TRIALS,
    min_step: float = MIN_STEP,
) -> bool:
    """Median rule: prune when current's best-so-far is worse than the
    median of the other trials' running averages at the same step."""
    if not current:
        return False
    step = current[-1][0]
    if step < min_step:
        return False
    avgs = [a for a in (running_average_at(h, step) for h in others) if a is not None]
    if len(avgs) < min_trials:
        return False
    med = statistics.median(avgs)
    best = max(v for _, v in current) if maximize else min(v for _, v in current)
    return best < med if maximize else best > med

