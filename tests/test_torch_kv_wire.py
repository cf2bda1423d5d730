"""kubeflow_tpu_torch/serving/kv_wire.py against kubeflow_tpu/serving/kv_wire.py.

The port frames the same blob byte for byte: a bf16 ``export_kv`` of the
same row cache and meta is byte-identical to JAX's (bf16 travels as its
16-bit words without ``ml_dtypes`` on the port's side), each package reads
the other's blobs, and ``unpack`` refuses what JAX's refuses. An int8
blob crossing packages is NOT byte-identical: the port quantizes with its
``quantize_kv``, which equals JAX's eager ``quantize_kv`` exactly, while
JAX's ``export_kv`` uses the jitted ``quantize_kv_jit`` — codes within ±1,
scales within 1 ULP (ROADMAP.md C.3).
"""

import json
import struct

import ml_dtypes
import numpy as np
import pytest
import torch

from kubeflow_tpu.serving import kv_wire as jwire
from kubeflow_tpu_torch.serving import kv_wire as twire

LAYERS, MAX_SEQ, HEADS, HEAD_DIM, BLOCK_T = 2, 48, 2, 8, 16


def _bf16_rows(seed=0, scale=1.0):
    """The same bf16 values for both packages: ml_dtypes arrays for JAX,
    torch.bfloat16 views of the same 16-bit words for the port."""
    rng = np.random.default_rng(seed)
    jrows, trows = {}, {}
    for i in range(LAYERS):
        jrows[f"block_{i}"], trows[f"block_{i}"] = {}, {}
        for kind in ("k", "v"):
            x = (rng.standard_normal((MAX_SEQ, HEADS, HEAD_DIM)) * scale).astype(
                ml_dtypes.bfloat16)
            jrows[f"block_{i}"][kind] = x
            trows[f"block_{i}"][kind] = torch.from_numpy(
                x.view(np.int16).copy()).view(torch.bfloat16)
    return jrows, trows


META = dict(prompt_len=21, block_t=BLOCK_T, first_token=7, model_id="gpt")


def test_pack_unpack_round_trip_keeps_every_dtype_and_bit():
    rng = np.random.default_rng(1)
    bf = torch.randn(3, 4, 5).to(torch.bfloat16)
    arrays = {"a/f32": rng.standard_normal((2, 3)).astype(np.float32),
              "a/i8": torch.randint(-127, 128, (4, 2), dtype=torch.int8),
              "a/bf16": bf, "a/i32": np.arange(6, dtype=np.int32).reshape(2, 3)}
    blob = twire.pack({"prompt_len": 5}, arrays)
    meta, out = twire.unpack(blob)
    assert meta["prompt_len"] == 5 and meta["version"] == twire.WIRE_VERSION
    assert list(out) == list(arrays)
    assert out["a/bf16"].dtype == torch.bfloat16
    assert torch.equal(out["a/bf16"].view(torch.int16), bf.view(torch.int16))
    assert torch.equal(out["a/i8"], arrays["a/i8"])
    np.testing.assert_array_equal(out["a/f32"].numpy(), arrays["a/f32"])
    np.testing.assert_array_equal(out["a/i32"].numpy(), arrays["a/i32"])
    assert [e["dtype"] for e in meta["arrays"]] == ["float32", "int8", "bfloat16", "int32"]


def _blob():
    return twire.pack({"prompt_len": 5}, {"x": np.arange(24, dtype=np.float32)})


def _bad_version(blob):
    mlen = struct.unpack_from("<I", blob, 4)[0]
    manifest = json.loads(blob[8:8 + mlen])
    manifest["version"] = 2
    m = json.dumps(manifest, sort_keys=True).encode()
    return blob[:4] + struct.pack("<I", len(m)) + m + blob[8 + mlen:]


def _flip_last(blob):
    bad = bytearray(blob)
    bad[-1] ^= 0xFF
    return bytes(bad)


REFUSALS = {
    "bad_magic": (lambda b: b"KVW2" + b[4:], "bad magic"),
    "wrong_version": (_bad_version, "version"),
    "truncated_manifest": (lambda b: b[:20], "truncated KV wire manifest"),
    "truncated_payload": (lambda b: b[:-4], "truncated KV wire payload"),
    "crc_mismatch": (_flip_last, "crc mismatch"),
    "trailing_bytes": (lambda b: b + b"\0", "trailing bytes"),
}


@pytest.mark.parametrize("case", sorted(REFUSALS))
def test_unpack_refuses_what_jax_refuses(case):
    corrupt, match = REFUSALS[case]
    bad = corrupt(_blob())
    with pytest.raises(ValueError, match=match):
        twire.unpack(bad)
    with pytest.raises(ValueError):
        jwire.unpack(bad)


def test_bf16_export_is_byte_identical_to_jax_and_reads_back_both_ways():
    jrows, trows = _bf16_rows()
    want = jwire.export_kv(jrows, kv_dtype="bf16", **META)
    got = twire.export_kv(trows, kv_dtype="bf16", **META)
    assert got == want
    # JAX's blob through the port's unpack_kv: bf16 words, not values cast
    manifest, arrays = twire.unpack_kv(want)
    nb = -(-META["prompt_len"] // BLOCK_T)
    assert manifest["n_layers"] == LAYERS and manifest["first_token"] == 7
    k = arrays["block_1/k"]
    assert k.dtype == torch.bfloat16 and tuple(k.shape) == (nb, BLOCK_T, HEADS, HEAD_DIM)
    assert torch.equal(k.reshape(-1, HEADS, HEAD_DIM),
                       trows["block_1"]["k"][:nb * BLOCK_T])
    # and the port's through JAX's
    _, jarrays = jwire.unpack_kv(got)
    np.testing.assert_array_equal(
        jarrays["block_0/v"].view(np.int16),
        jrows["block_0"]["v"][:nb * BLOCK_T].reshape(nb, BLOCK_T, HEADS, HEAD_DIM)
        .view(np.int16))


def test_int8_export_read_by_jax_codes_within_one_scales_within_one_ulp():
    jrows, trows = _bf16_rows(seed=2, scale=3.0)
    got = twire.export_kv(trows, kv_dtype="int8", **META)
    want = jwire.export_kv(jrows, kv_dtype="int8", **META)
    manifest, jarrays = jwire.unpack_kv(got)  # crc valid on JAX's side
    _, ref = jwire.unpack_kv(want)
    assert manifest["kv_dtype"] == "int8" and sorted(jarrays) == sorted(ref)
    for name, arr in ref.items():
        mine = jarrays[name]
        assert mine.dtype == arr.dtype and mine.shape == arr.shape
        if name.endswith("_scale"):
            ulp = np.spacing(np.abs(arr).astype(np.float32))
            assert np.all(np.abs(mine - arr) <= ulp), name
        else:
            diff = np.abs(mine.astype(np.int32) - arr.astype(np.int32))
            assert diff.max() <= 1, name
    # the port's int8 quantizer is the engine's: the blob's codes are it
    from kubeflow_tpu_torch.ops.kv_cache import quantize_kv
    _, tarrays = twire.unpack_kv(got)
    nb = -(-META["prompt_len"] // BLOCK_T)
    q, s = quantize_kv(trows["block_0"]["k"][:nb * BLOCK_T].reshape(
        nb, BLOCK_T, HEADS, HEAD_DIM))
    assert torch.equal(tarrays["block_0/k"], q) and torch.equal(tarrays["block_0/k_scale"], s)


def test_unpack_kv_requires_the_export_fields():
    blob = twire.pack({"prompt_len": 3}, {"x": np.zeros(2, np.float32)})
    with pytest.raises(ValueError, match="block_t"):
        twire.unpack_kv(blob)
    with pytest.raises(ValueError, match="positive block_t"):
        twire.export_kv({}, prompt_len=3, block_t=0, kv_dtype="bf16", first_token=0)
