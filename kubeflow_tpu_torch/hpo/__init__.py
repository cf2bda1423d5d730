"""Hyperparameter optimization in the port: the objective functions a
study's trials run (``hpo/trials.py``), the suggestion algorithms and the
median stopping rule (``suggest.py``, ``earlystop.py``: copies of the JAX
package's) and the in-process study loop (``study.py``). The StudyJob
controller, its apiserver objects and the metrics reporter belong to the
JAX package's control plane and are not ported."""

from .trials import mnist_objective, quadratic_objective  # noqa: F401
