"""Suggestion algorithms: random, grid, and Gaussian-process Bayesian.

The port's own copy of ``kubeflow_tpu/hpo/suggest.py`` (numpy and the
standard library only): the same arithmetic, so that the same specs, seed
and history give the same asks in both packages. Katib's algorithm
services are external gRPC processes; here they are in-process numpy. The
Bayesian suggester is a GP with an RBF kernel and expected-improvement
acquisition over unit-cube-normalized parameters.
"""

from __future__ import annotations

import itertools
import math
import random as pyrandom
from dataclasses import dataclass
from typing import Any, Dict, List, Optional, Sequence

import numpy as np


@dataclass(frozen=True)
class ParamSpec:
    """One search dimension (StudyJob spec.parameters[] entry)."""

    name: str
    type: str  # "double" | "int" | "categorical" | "discrete"
    min: Optional[float] = None
    max: Optional[float] = None
    step: Optional[float] = None
    values: Sequence[Any] = ()
    log_scale: bool = False

    def validate(self) -> None:
        if self.type in ("double", "int"):
            if self.min is None or self.max is None or self.min > self.max:
                raise ValueError(f"param {self.name}: need min <= max")
            if self.log_scale and self.min <= 0:
                raise ValueError(f"param {self.name}: log scale needs min > 0")
        elif self.type in ("categorical", "discrete"):
            if not self.values:
                raise ValueError(f"param {self.name}: values required")
        else:
            raise ValueError(f"param {self.name}: unknown type {self.type!r}")

    # -- unit-cube encoding (for the GP) ------------------------------------
    def to_unit(self, value: Any) -> float:
        if self.type in ("double", "int"):
            lo, hi = float(self.min), float(self.max)
            if self.log_scale:
                return (math.log(float(value)) - math.log(lo)) / max(
                    math.log(hi) - math.log(lo), 1e-12
                )
            return (float(value) - lo) / max(hi - lo, 1e-12)
        return self.values.index(value) / max(len(self.values) - 1, 1)

    def from_unit(self, u: float) -> Any:
        u = min(max(u, 0.0), 1.0)
        if self.type in ("double", "int"):
            lo, hi = float(self.min), float(self.max)
            if self.log_scale:
                value = math.exp(math.log(lo) + u * (math.log(hi) - math.log(lo)))
            else:
                value = lo + u * (hi - lo)
            if self.type == "int":
                return int(round(value))
            return value
        idx = int(round(u * (len(self.values) - 1)))
        return self.values[idx]

    def grid_points(self, resolution: int = 4) -> List[Any]:
        if self.type in ("categorical", "discrete"):
            return list(self.values)
        if self.type == "int":
            lo, hi = int(self.min), int(self.max)
            if hi - lo + 1 <= resolution:
                return list(range(lo, hi + 1))
        return [self.from_unit(i / (resolution - 1)) for i in range(resolution)]


@dataclass
class Observation:
    params: Dict[str, Any]
    objective: float


class Suggester:
    """Stateful: tell() observations, ask() the next parameter sets."""

    def __init__(self, specs: Sequence[ParamSpec], maximize: bool = True, seed: int = 0):
        for s in specs:
            s.validate()
        self.specs = list(specs)
        self.maximize = maximize
        self.observations: List[Observation] = []
        self._rng = pyrandom.Random(seed)

    def tell(self, params: Dict[str, Any], objective: float) -> None:
        self.observations.append(Observation(params, objective))

    def ask(self, count: int = 1) -> List[Dict[str, Any]]:
        raise NotImplementedError

    def best(self) -> Optional[Observation]:
        if not self.observations:
            return None
        key = (lambda o: o.objective) if self.maximize else (lambda o: -o.objective)
        return max(self.observations, key=key)

    def _random_params(self) -> Dict[str, Any]:
        return {s.name: s.from_unit(self._rng.random()) for s in self.specs}


class RandomSuggester(Suggester):
    def ask(self, count: int = 1) -> List[Dict[str, Any]]:
        return [self._random_params() for _ in range(count)]


class GridSuggester(Suggester):
    def __init__(self, specs, maximize=True, seed=0, resolution: int = 4):
        super().__init__(specs, maximize, seed)
        self._grid = [
            dict(zip([s.name for s in self.specs], combo))
            for combo in itertools.product(*(s.grid_points(resolution) for s in self.specs))
        ]
        self._cursor = 0

    def ask(self, count: int = 1) -> List[Dict[str, Any]]:
        out = self._grid[self._cursor : self._cursor + count]
        self._cursor += len(out)
        return out

    @property
    def exhausted(self) -> bool:
        return self._cursor >= len(self._grid)


class BayesianSuggester(Suggester):
    """GP(RBF) + expected improvement, candidates by random sampling.

    Dimensions are the unit-cube encodings; categorical dims ride along as
    ordinal codes (coarse but standard for small search spaces).
    """

    def __init__(self, specs, maximize=True, seed=0, n_candidates: int = 256,
                 length_scale: float = 0.25, noise: float = 1e-6, n_startup: int = 4):
        super().__init__(specs, maximize, seed)
        self.n_candidates = n_candidates
        self.length_scale = length_scale
        self.noise = noise
        self.n_startup = n_startup

    def _encode(self, params: Dict[str, Any]) -> np.ndarray:
        return np.array([s.to_unit(params[s.name]) for s in self.specs])

    def _kernel(self, a: np.ndarray, b: np.ndarray) -> np.ndarray:
        d2 = ((a[:, None, :] - b[None, :, :]) ** 2).sum(-1)
        return np.exp(-0.5 * d2 / self.length_scale**2)

    def ask(self, count: int = 1) -> List[Dict[str, Any]]:
        out: List[Dict[str, Any]] = []
        pending: List[np.ndarray] = []
        for _ in range(count):
            if len(self.observations) < self.n_startup:
                params = self._random_params()
                out.append(params)
                pending.append(self._encode(params))
                continue
            X = np.stack(
                [self._encode(o.params) for o in self.observations]
                + pending  # liar strategy: pending points repel new ones
            )
            y = np.array(
                [o.objective for o in self.observations]
                + [self._pessimistic_value()] * len(pending),
                dtype=np.float64,
            )
            if not self.maximize:
                y = -y
            y_mean, y_std = y.mean(), max(y.std(), 1e-9)
            yn = (y - y_mean) / y_std

            K = self._kernel(X, X) + self.noise * np.eye(len(X))
            L = np.linalg.cholesky(K)
            alpha = np.linalg.solve(L.T, np.linalg.solve(L, yn))

            cands = np.array(
                [[self._rng.random() for _ in self.specs] for _ in range(self.n_candidates)]
            )
            Ks = self._kernel(cands, X)
            mu = Ks @ alpha
            v = np.linalg.solve(L, Ks.T)
            var = np.clip(1.0 - (v**2).sum(0), 1e-12, None)
            sigma = np.sqrt(var)
            best = yn.max()
            z = (mu - best) / sigma
            ei = sigma * (z * _norm_cdf(z) + _norm_pdf(z))
            pick = cands[int(np.argmax(ei))]
            params = {s.name: s.from_unit(u) for s, u in zip(self.specs, pick)}
            out.append(params)
            pending.append(self._encode(params))
        return out

    def _pessimistic_value(self) -> float:
        vals = [o.objective for o in self.observations]
        return min(vals) if self.maximize else max(vals)


def _norm_pdf(z: np.ndarray) -> np.ndarray:
    return np.exp(-0.5 * z**2) / math.sqrt(2 * math.pi)


def _norm_cdf(z: np.ndarray) -> np.ndarray:
    from math import erf

    return np.vectorize(lambda t: 0.5 * (1 + erf(t / math.sqrt(2))))(z)


ALGORITHMS = {
    "random": RandomSuggester,
    "grid": GridSuggester,
    "bayesianoptimization": BayesianSuggester,
    "bayesian": BayesianSuggester,
}


def make_suggester(algorithm: str, specs: Sequence[ParamSpec], maximize: bool, seed: int = 0) -> Suggester:
    try:
        cls = ALGORITHMS[algorithm.lower()]
    except KeyError:
        raise ValueError(f"unknown algorithm {algorithm!r}; known: {sorted(ALGORITHMS)}") from None
    return cls(specs, maximize=maximize, seed=seed)
