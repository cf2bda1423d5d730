"""Crash-safe training-state persistence: the port of
``kubeflow_tpu/training/checkpoint.py``.

The same on-disk format, so each package restores what the other wrote:

- a step is a directory ``step_<N>`` holding one ``leaf_{i:05d}.npy`` per
  leaf and a ``manifest.json`` (``format`` 1, ``step``, ``meta`` and, per
  leaf, its ``path`` tokens, ``key``, ``file``, ``shape``, ``dtype``,
  ``bytes`` and ``crc32``);
- leaves are numbered in ``jax.tree_util.tree_flatten_with_path`` order:
  dict keys sorted, sequences by index, ``None`` an empty node. A dict key
  is the token ``["d", key]`` and renders as ``[repr(key)]``; a list or
  tuple index is ``["s", i]`` and renders as ``[i]``;
- **atomic commit**: a save writes into ``_tmp.<step>.<hex>``, fsyncs each
  file, the manifest and the directory, renames it to ``step_<N>`` and
  fsyncs the parent; a process killed mid-save leaves only a ``_tmp.*``
  directory, reclaimed on the next open;
- **corruption skip-over**: ``latest_step``/``all_steps`` skip steps whose
  manifest is unreadable or whose leaf files have the wrong size;
  ``restore`` walks from the newest step to the oldest past a step that
  fails its crc32 or differs in structure from the template, and raises
  ``FileNotFoundError`` only when none is usable;
- **bounded retention**: ``max_to_keep`` never deletes the newest complete
  step.

The port's pytree is nested ``dict``/``list``/``tuple`` of tensors, numpy
arrays or Python scalars. A tensor is saved as its CPU numpy value; a
bfloat16 tensor, which numpy cannot hold, as its 2-byte words in a
``'<V2'`` ``.npy`` (the file JAX writes for a bfloat16 leaf) with manifest
dtype ``"bfloat16"``. Such a leaf, the port's or JAX's, restores as a
``torch.bfloat16`` tensor with the same bits (the JAX ``Checkpointer``
cannot restore its own: ROADMAP.md C.4). ``restore(template)`` puts each
leaf on its template leaf's device and dtype.
"""

from __future__ import annotations

import json
import os
import shutil
import threading
import time
import uuid
import zlib
from typing import Any, Dict, Iterator, List, Optional, Tuple

import numpy as np
import torch

from ..runtime.metrics import METRICS

_STEP_PREFIX = "step_"
_TMP_PREFIX = "_tmp."
_MANIFEST = "manifest.json"
_FORMAT = 1
_BF16 = "bfloat16"

#: urgent drain saves must land inside the preemption grace window:
#: sub-second buckets matter as much as the multi-second tail
SAVE_BUCKETS = (0.005, 0.01, 0.05, 0.1, 0.25, 0.5, 1.0, 2.5, 5.0, 10.0, 30.0)

Tokens = List[List[Any]]


class CorruptCheckpoint(Exception):
    """A step directory failed validation (internal: callers see skip-over)."""


def _flatten(tree: Any, path: Tokens = None) -> Iterator[Tuple[Tokens, Any]]:
    """(path tokens, leaf) in ``tree_flatten_with_path`` order."""
    path = path or []
    if tree is None:
        return
    if isinstance(tree, dict):
        for k in sorted(tree):
            yield from _flatten(tree[k], path + [["d", k]])
    elif isinstance(tree, (list, tuple)):
        for i, v in enumerate(tree):
            yield from _flatten(v, path + [["s", i]])
    else:
        yield path, tree


def _unflatten(template: Any, leaves: Iterator[Any]) -> Any:
    """``template``'s structure with its leaves replaced, in order."""
    if template is None:
        return None
    if isinstance(template, dict):
        return {k: _unflatten(template[k], leaves) for k in sorted(template)}
    if isinstance(template, (list, tuple)):
        return type(template)(_unflatten(v, leaves) for v in template)
    return next(leaves)


def _keystr(tokens: Tokens) -> str:
    """``jax.tree_util.keystr`` of a path: ``['a'][0][1]``."""
    return "".join(f"[{k!r}]" if kind == "d" else f"[{k}]" for kind, k in tokens)


def _leaf_to_numpy(leaf: Any) -> Tuple[np.ndarray, str]:
    """(array to write, manifest dtype); a bfloat16 tensor becomes its
    2-byte words."""
    if isinstance(leaf, torch.Tensor):
        t = leaf.detach().cpu().contiguous()
        if t.dtype == torch.bfloat16:
            return t.view(torch.int16).numpy().view(np.dtype("V2")), _BF16
        arr = t.numpy()
    else:
        arr = np.asarray(leaf)
    return arr, str(arr.dtype)


def _write_leaf(path: str, arr: np.ndarray, dtype: str) -> None:
    with open(path, "wb") as f:
        if dtype == _BF16:  # JAX's header for an ml_dtypes bfloat16 array
            np.lib.format.write_array_header_1_0(
                f, {"descr": "<V2", "fortran_order": False, "shape": arr.shape})
            f.write(np.ascontiguousarray(arr).tobytes())
        else:
            np.save(f, arr, allow_pickle=False)
        f.flush()
        os.fsync(f.fileno())


def _fsync_dir(path: str) -> None:
    fd = os.open(path, os.O_RDONLY)
    try:
        os.fsync(fd)
    finally:
        os.close(fd)


class Checkpointer:
    """Save and restore a training-state pytree under a step-indexed
    directory.

    Usage (inside a training loop)::

        ckpt = Checkpointer("/home/jovyan/ckpt", max_to_keep=3)
        start = ckpt.latest_step()
        state = ckpt.restore(state) if start is not None else state
        for step in range((start or -1) + 1, total):
            state = train_step(state, ...)
            ckpt.maybe_save(step, state, every=100)
    """

    def __init__(self, directory: str, max_to_keep: int = 3):
        self.directory = os.path.abspath(directory)
        self.max_to_keep = max(1, int(max_to_keep))
        os.makedirs(self.directory, exist_ok=True)
        self._lock = threading.Lock()
        # a process killed mid-save leaves _tmp.* directories; never renamed,
        # hence never visible: reclaim the space
        for entry in os.listdir(self.directory):
            if entry.startswith(_TMP_PREFIX):
                shutil.rmtree(os.path.join(self.directory, entry), ignore_errors=True)

    # -- introspection -----------------------------------------------------
    def latest_step(self) -> Optional[int]:
        """Newest step with a COMPLETE checkpoint (partial ones skipped)."""
        steps = self.all_steps()
        return steps[-1] if steps else None

    def all_steps(self) -> List[int]:
        """Sorted steps whose checkpoints validate (manifest + leaf sizes)."""
        return [s for s in self._candidate_steps() if self._is_complete(s)]

    def read_meta(self, step: Optional[int] = None) -> Dict[str, Any]:
        """The ``meta`` dict stored beside a checkpoint ({} if absent)."""
        manifest = self._load_manifest(self._resolve_step(step))
        return manifest.get("meta") or {}

    # -- save / restore ----------------------------------------------------
    def save(self, step: int, state: Any, wait: bool = True,
             meta: Optional[Dict[str, Any]] = None) -> None:
        """Atomically persist ``state`` plus a JSON ``meta`` dict.
        Thread-safe: an urgent save serializes against one in flight.
        ``wait`` is kept for the JAX signature; saves are synchronous."""
        del wait
        t0 = time.perf_counter()
        with self._lock:
            self._save_locked(int(step), state, meta)
        METRICS.histogram("checkpoint_save_seconds", buckets=SAVE_BUCKETS).observe(
            time.perf_counter() - t0)

    def _save_locked(self, step: int, state: Any, meta: Optional[Dict[str, Any]]) -> None:
        tmp = os.path.join(self.directory, f"{_TMP_PREFIX}{step}.{uuid.uuid4().hex[:8]}")
        os.makedirs(tmp)
        entries = []
        for i, (tokens, leaf) in enumerate(_flatten(state)):
            arr, dtype = _leaf_to_numpy(leaf)
            fname = f"leaf_{i:05d}.npy"
            fpath = os.path.join(tmp, fname)
            _write_leaf(fpath, arr, dtype)
            entries.append({
                "path": tokens,
                "key": _keystr(tokens),
                "file": fname,
                "shape": list(arr.shape),
                "dtype": dtype,
                "bytes": os.path.getsize(fpath),
                "crc32": zlib.crc32(np.ascontiguousarray(arr).tobytes()),
            })
        manifest = {"format": _FORMAT, "step": step, "meta": meta or {}, "leaves": entries}
        with open(os.path.join(tmp, _MANIFEST), "w") as f:
            json.dump(manifest, f)
            f.flush()
            os.fsync(f.fileno())
        _fsync_dir(tmp)
        final = self._step_dir(step)
        if os.path.exists(final):  # a re-save of a step replaces it
            shutil.rmtree(final, ignore_errors=True)
        os.rename(tmp, final)
        _fsync_dir(self.directory)
        self._gc_locked()

    def maybe_save(self, step: int, state: Any, every: int, wait: bool = False,
                   meta: Optional[Dict[str, Any]] = None) -> bool:
        if every <= 0 or step % every != 0:
            return False
        self.save(step, state, wait=wait, meta=meta)
        return True

    def restore(self, state_template: Any, step: Optional[int] = None) -> Any:
        """Restore into the structure, devices and dtypes of
        ``state_template``. With ``step=None``, walks newest → oldest past
        corrupt checkpoints and ones whose structure differs from the
        template."""
        t0 = time.perf_counter()
        template = list(_flatten(state_template))
        for chosen in self._restore_order(step):
            try:
                arrays, _meta = self._load_arrays(chosen)
            except CorruptCheckpoint:
                continue
            keys = [_keystr(tokens) for tokens, _ in template]
            if any(k not in arrays for k in keys):
                continue  # structure drifted; an older step may still match
            out = [_place_like(arrays[k], leaf) for k, (_, leaf) in zip(keys, template)]
            self._observe_restore(t0)
            return _unflatten(state_template, iter(out))
        raise FileNotFoundError(f"no usable checkpoint under {self.directory}")

    def restore_numpy(self, step: Optional[int] = None) -> Tuple[Any, Dict[str, Any]]:
        """(tree, meta) without a template: nested dicts and lists of numpy
        arrays (a bfloat16 leaf as a ``torch.bfloat16`` tensor). Walks
        newest → oldest past corrupt checkpoints."""
        t0 = time.perf_counter()
        for chosen in self._restore_order(step):
            try:
                manifest = self._load_manifest(chosen)
                arrays, meta = self._load_arrays(chosen, manifest)
            except CorruptCheckpoint:
                continue
            tree: Any = None
            for entry in manifest["leaves"]:
                tree = _insert_by_tokens(tree, entry["path"], arrays[entry["key"]])
            self._observe_restore(t0)
            return tree, meta
        raise FileNotFoundError(f"no usable checkpoint under {self.directory}")

    @staticmethod
    def _observe_restore(t0: float) -> None:
        # only successful restores count: a FileNotFoundError walk over an
        # empty directory is the init path, not a restore's cost
        METRICS.histogram("checkpoint_restore_seconds", buckets=SAVE_BUCKETS).observe(
            time.perf_counter() - t0)

    def wait(self) -> None:
        with self._lock:
            pass  # saves are synchronous: returning means none is in flight

    def close(self) -> None:
        self.wait()

    # -- internals ---------------------------------------------------------
    def _step_dir(self, step: int) -> str:
        return os.path.join(self.directory, f"{_STEP_PREFIX}{step}")

    def _candidate_steps(self) -> List[int]:
        try:
            entries = os.listdir(self.directory)
        except FileNotFoundError:
            return []
        steps = []
        for entry in entries:
            if entry.startswith(_STEP_PREFIX):
                try:
                    steps.append(int(entry[len(_STEP_PREFIX):]))
                except ValueError:
                    continue
        return sorted(steps)

    def _restore_order(self, step: Optional[int]) -> List[int]:
        if step is not None:
            return [int(step)] if self._is_complete(int(step)) else []
        return list(reversed(self.all_steps()))

    def _resolve_step(self, step: Optional[int]) -> int:
        if step is None:
            latest = self.latest_step()
            if latest is None:
                raise FileNotFoundError(f"no usable checkpoint under {self.directory}")
            return latest
        return int(step)

    def _load_manifest(self, step: int) -> Dict[str, Any]:
        try:
            with open(os.path.join(self._step_dir(step), _MANIFEST)) as f:
                manifest = json.load(f)
        except (OSError, ValueError) as e:
            raise CorruptCheckpoint(f"step {step}: unreadable manifest: {e}") from None
        if manifest.get("format") != _FORMAT or "leaves" not in manifest:
            raise CorruptCheckpoint(f"step {step}: unknown manifest format")
        return manifest

    def _is_complete(self, step: int) -> bool:
        try:
            manifest = self._load_manifest(step)
        except CorruptCheckpoint:
            return False
        d = self._step_dir(step)
        for entry in manifest["leaves"]:
            try:
                if os.path.getsize(os.path.join(d, entry["file"])) != entry["bytes"]:
                    return False
            except OSError:
                return False
        return True

    def _load_arrays(self, step: int, manifest: Optional[Dict[str, Any]] = None
                     ) -> Tuple[Dict[str, Any], Dict[str, Any]]:
        manifest = manifest if manifest is not None else self._load_manifest(step)
        d = self._step_dir(step)
        arrays: Dict[str, Any] = {}
        for entry in manifest["leaves"]:
            try:
                arr = np.load(os.path.join(d, entry["file"]), allow_pickle=False)
            except (OSError, ValueError) as e:
                raise CorruptCheckpoint(f"step {step}: {entry['file']}: {e}") from None
            if zlib.crc32(np.ascontiguousarray(arr).tobytes()) != entry["crc32"]:
                raise CorruptCheckpoint(f"step {step}: {entry['file']}: crc mismatch")
            if entry.get("dtype") == _BF16:
                arr = torch.from_numpy(np.ascontiguousarray(arr).view(np.int16)
                                       ).view(torch.bfloat16)
            arrays[entry["key"]] = arr
        return arrays, manifest.get("meta") or {}

    def _gc_locked(self) -> None:
        """Keep the newest ``max_to_keep`` COMPLETE checkpoints. Only steps
        older than the newest complete one are ever deleted, so retention
        can never eat the checkpoint a restart is about to read."""
        complete = self.all_steps()
        if not complete:
            return
        doomed = complete[:-1][: max(0, len(complete) - self.max_to_keep)]
        for s in doomed:
            shutil.rmtree(self._step_dir(s), ignore_errors=True)


def _place_like(value: Any, template_leaf: Any) -> Any:
    """A restored leaf where and as the template leaf is: a tensor on its
    device in its dtype, a Python scalar as its type, else as loaded."""
    if isinstance(template_leaf, torch.Tensor):
        t = value if isinstance(value, torch.Tensor) else torch.from_numpy(value)
        return t.to(device=template_leaf.device, dtype=template_leaf.dtype)
    if isinstance(template_leaf, (bool, int, float)):
        return type(template_leaf)(value.item())
    return value


def _insert_by_tokens(tree: Any, tokens: Tokens, value: Any) -> Any:
    """Rebuild a dict/list pytree from tokenized leaf paths."""
    if not tokens:
        return value
    kind, key = tokens[0]
    if kind == "d":
        node = tree if isinstance(tree, dict) else {}
        node[key] = _insert_by_tokens(node.get(key), tokens[1:], value)
        return node
    if kind in ("s", "i"):
        node = tree if isinstance(tree, list) else []
        while len(node) <= key:
            node.append(None)
        node[key] = _insert_by_tokens(node[key], tokens[1:], value)
        return node
    raise CorruptCheckpoint(
        f"restore_numpy supports dict/list trees only; saw path token {kind!r}")
