"""The store's storage backend: plain dicts.

A trimmed copy of ``kubeflow_tpu/apiserver/backend.py``'s ``DictBackend``.
The JAX package also has a C++ storage core with a write journal
(``NativeBackend``) and a write-ahead log (``apiserver/wal.py``); the port
keeps neither yet. Watches resume from a resourceVersion through the
store's watch-cache ring (``store.py``), which needs no journal.
"""

from __future__ import annotations

import json
from typing import Any, Dict, List, Optional, Tuple

from ..api import meta as apimeta


class DictBackend:
    """Pure-Python storage: one dict of objects per bucket, no journal."""

    def __init__(self) -> None:
        self._rv = 0
        self._data: Dict[str, Dict[Tuple[str, str], Dict[str, Any]]] = {}

    def next_rv(self) -> int:
        self._rv += 1
        return self._rv

    def current_rv(self) -> int:
        return self._rv

    def contains(self, bucket: str, ns: str, name: str) -> bool:
        return (ns, name) in self._data.get(bucket, {})

    def get(self, bucket: str, ns: str, name: str) -> Optional[Dict[str, Any]]:
        obj = self._data.get(bucket, {}).get((ns, name))
        return apimeta.deepcopy(obj) if obj is not None else None

    def put(self, bucket: str, ns: str, name: str, obj: Dict[str, Any], rv: int, op: str) -> None:
        # a JSON round trip, not a deepcopy: the stored object has the wire
        # shape (tuples become lists, values JSON cannot carry are refused),
        # as a real apiserver serializes to etcd
        self._data.setdefault(bucket, {})[(ns, name)] = json.loads(
            json.dumps(obj, separators=(",", ":")))

    def delete(self, bucket: str, ns: str, name: str, final_obj: Dict[str, Any], rv: int) -> None:
        self._data.get(bucket, {}).pop((ns, name), None)

    def list(self, bucket: str, ns: Optional[str] = None,
             selector: Optional[Dict[str, str]] = None) -> List[Dict[str, Any]]:
        out = []
        for (obj_ns, _), obj in self._data.get(bucket, {}).items():
            if ns is not None and obj_ns != ns:
                continue
            if selector:
                labels = apimeta.labels_of(obj)
                if any(labels.get(k) != v for k, v in selector.items()):
                    continue
            out.append(apimeta.deepcopy(obj))
        return out

    def list_all(self) -> List[Tuple[str, Dict[str, Any]]]:
        return [(bucket, apimeta.deepcopy(obj))
                for bucket, entries in self._data.items() for obj in entries.values()]
