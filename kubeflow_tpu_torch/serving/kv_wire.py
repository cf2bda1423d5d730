"""KV wire format: how a prefilled request moves from a prefill-role engine
to a decode-role engine. The port of ``kubeflow_tpu/serving/kv_wire.py``;
the frame is the same, byte for byte::

    b"KVW1" | u32 manifest_len (little-endian) | manifest JSON | payload

The manifest (``json.dumps(..., sort_keys=True)``) carries the request's
meta plus, for each array in payload order, its dtype name, shape, byte
count and crc32; ``unpack`` verifies all of it and raises ``ValueError`` on
a bad magic, a wrong version, a truncation, a crc mismatch or trailing
bytes.

Arrays are torch tensors on the host. A ``torch.bfloat16`` tensor goes on
the wire as its raw 16-bit words under the dtype name ``"bfloat16"`` (what
numpy with ``ml_dtypes`` calls it), so a blob of the same values and meta
is byte-identical to the JAX package's; ``unpack`` hands it back as a
``torch.bfloat16`` view of the words, never a cast through float.

Arrays are block-shaped: ``block_{i}/k`` and ``block_{i}/v`` are
``[nb, block_t, heads, head_dim]`` with ``nb = ceil(prompt_len /
block_t)``. Positions past ``prompt_len`` in the last block carry prefill
padding, which the decode side's mask hides until decode overwrites it.
With ``kv_dtype="int8"`` the blocks ship quantized by
``ops.kv_cache.quantize_kv`` — the quantizer the engine's adopt uses — with
``block_{i}/k_scale`` and ``v_scale`` (``[nb, block_t, heads, 1]`` f32)
beside them, so a moved request's arena blocks are byte-identical to a
never-moved one's.
"""

from __future__ import annotations

import json
import struct
import zlib
from typing import Any, Dict, Tuple, Union

import numpy as np
import torch

from ..ops.kv_cache import quantize_kv

MAGIC = b"KVW1"
WIRE_VERSION = 1

#: wire dtype name -> torch dtype (numpy's names; "bfloat16" as ml_dtypes
#: names it)
_DTYPES = {"bfloat16": torch.bfloat16, "float16": torch.float16,
           "float32": torch.float32, "float64": torch.float64,
           "int8": torch.int8, "uint8": torch.uint8, "int16": torch.int16,
           "int32": torch.int32, "int64": torch.int64, "bool": torch.bool}
_NAMES = {v: k for k, v in _DTYPES.items()}

Array = Union[torch.Tensor, np.ndarray]


def _raw(t: torch.Tensor) -> bytes:
    """The tensor's bytes in C order; bf16 as its 16-bit words."""
    t = t.detach().cpu().contiguous()
    if t.dtype == torch.bfloat16:
        t = t.view(torch.int16)
    return t.numpy().tobytes()


def pack(meta: Dict[str, Any], arrays: Dict[str, Array]) -> bytes:
    """Frame ``arrays`` (name -> tensor or ndarray, insertion order kept)
    behind a manifest carrying ``meta`` plus each array's dtype, shape,
    byte count and crc32."""
    entries = []
    payload = bytearray()
    for name, arr in arrays.items():
        t = torch.from_numpy(np.ascontiguousarray(arr)) if isinstance(arr, np.ndarray) else arr
        if t.dtype not in _NAMES:
            raise ValueError(f"KV wire: no wire name for dtype {t.dtype} ({name!r})")
        buf = _raw(t)
        entries.append({"name": name, "dtype": _NAMES[t.dtype], "shape": list(t.shape),
                        "nbytes": len(buf), "crc32": zlib.crc32(buf) & 0xFFFFFFFF})
        payload.extend(buf)
    manifest = dict(meta)
    manifest["version"] = WIRE_VERSION
    manifest["arrays"] = entries
    mbytes = json.dumps(manifest, sort_keys=True).encode("utf-8")
    return MAGIC + struct.pack("<I", len(mbytes)) + mbytes + bytes(payload)


def _tensor(buf: bytes, dtype: str, shape) -> torch.Tensor:
    if dtype not in _DTYPES:
        raise ValueError(f"KV wire: unknown dtype {dtype!r}")
    want = _DTYPES[dtype]
    words = torch.int16 if want == torch.bfloat16 else want
    np_dtype = torch.empty((), dtype=words).numpy().dtype
    t = torch.from_numpy(np.frombuffer(buf, dtype=np_dtype).copy()).reshape(shape)
    return t.view(torch.bfloat16) if want == torch.bfloat16 else t


def unpack(blob: bytes) -> Tuple[Dict[str, Any], Dict[str, torch.Tensor]]:
    """Inverse of :func:`pack`: verifies the magic, the version, the
    framing and every array's crc32 (``ValueError`` on any mismatch);
    returns the manifest and the arrays as host tensors."""
    if len(blob) < len(MAGIC) + 4 or blob[:len(MAGIC)] != MAGIC:
        raise ValueError("not a KV wire blob (bad magic)")
    (mlen,) = struct.unpack_from("<I", blob, len(MAGIC))
    mstart = len(MAGIC) + 4
    if len(blob) < mstart + mlen:
        raise ValueError("truncated KV wire manifest")
    manifest = json.loads(blob[mstart:mstart + mlen].decode("utf-8"))
    if manifest.get("version") != WIRE_VERSION:
        raise ValueError(f"KV wire version {manifest.get('version')!r} "
                         f"(expected {WIRE_VERSION})")
    arrays: Dict[str, torch.Tensor] = {}
    off = mstart + mlen
    for e in manifest["arrays"]:
        buf = blob[off:off + e["nbytes"]]
        if len(buf) != e["nbytes"]:
            raise ValueError(f"truncated KV wire payload at {e['name']!r}")
        if (zlib.crc32(buf) & 0xFFFFFFFF) != e["crc32"]:
            raise ValueError(f"crc mismatch for {e['name']!r}")
        arrays[e["name"]] = _tensor(buf, e["dtype"], e["shape"])
        off += e["nbytes"]
    if off != len(blob):
        raise ValueError("trailing bytes after KV wire payload")
    return manifest, arrays


def export_kv(row_cache: Dict[str, Dict[str, torch.Tensor]], *, prompt_len: int,
              block_t: int, kv_dtype: str, first_token: int, model_id: str = "") -> bytes:
    """Export ONE prefilled request's KV to the wire.

    ``row_cache``: ``{"block_{i}": {"k": [>= nb*block_t, h, d], "v": ...}}``,
    one contiguous prefill-cache row per layer. Truncates to the whole
    blocks covering the prompt, reshapes block-wise and, for int8,
    quantizes with ``quantize_kv``: the engine's adopt quantizes with the
    same function, so moved and never-moved arenas hold the same bytes.
    """
    if block_t <= 0:
        raise ValueError("export_kv needs a positive block_t")
    nb = -(-int(prompt_len) // int(block_t))
    arrays: Dict[str, torch.Tensor] = {}
    for name, layer in row_cache.items():
        k = layer["k"][:nb * block_t]
        v = layer["v"][:nb * block_t]
        h, d = k.shape[-2], k.shape[-1]
        k = k.reshape(nb, block_t, h, d)
        v = v.reshape(nb, block_t, h, d)
        if kv_dtype == "int8":
            kq, ks = quantize_kv(k)
            vq, vs = quantize_kv(v)
            arrays[f"{name}/k"], arrays[f"{name}/v"] = kq, vq
            arrays[f"{name}/k_scale"], arrays[f"{name}/v_scale"] = ks, vs
        else:
            arrays[f"{name}/k"], arrays[f"{name}/v"] = k, v
    meta = {"prompt_len": int(prompt_len), "block_t": int(block_t),
            "kv_dtype": str(kv_dtype), "first_token": int(first_token),
            "model_id": str(model_id), "n_layers": len(row_cache)}
    return pack(meta, arrays)


def unpack_kv(blob: bytes) -> Tuple[Dict[str, Any], Dict[str, torch.Tensor]]:
    """Verify and parse a KV wire blob: :func:`unpack`, with the
    ``export_kv`` manifest fields required."""
    manifest, arrays = unpack(blob)
    for key in ("prompt_len", "block_t", "kv_dtype", "first_token"):
        if key not in manifest:
            raise ValueError(f"KV wire manifest missing {key!r}")
    return manifest, arrays
