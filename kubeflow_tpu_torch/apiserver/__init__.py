"""The port's apiserver (trimmed copies of ``kubeflow_tpu/apiserver/``):
the MVCC ``Store`` over ``DictBackend``, the controllers' ``Client``, the
REST app (``server``), ``RemoteStore`` for roles in other processes, and
``python -m kubeflow_tpu_torch.apiserver``. It imports no torch."""

from .store import ApiError, Conflict, Forbidden, Invalid, NotFound, Store, WatchEvent  # noqa: F401
from .client import Client  # noqa: F401
