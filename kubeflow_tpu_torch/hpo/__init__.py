"""Hyperparameter-optimization trial workloads of the port: the objective
functions a StudyJob's trials run (``hpo/trials.py``). The suggestion
algorithms, median stopping and the metrics reporter belong to the JAX
package's control plane and are not ported."""

from .trials import mnist_objective, quadratic_objective  # noqa: F401
