"""kubeflow_tpu_torch/models/bert.py, parallel/ring_attention.full_attention,
ops/flash_attention.auto_attention and the BERT servable against the JAX
package's, on the CPU, on the same seeded inputs and converted weights."""

import numpy as np
import pytest

import jax
import jax.numpy as jnp
import torch

from kubeflow_tpu.models.bert import BertConfig as JCfg, BertForMaskedLM as JBert
from kubeflow_tpu.parallel.ring_attention import full_attention as jax_full
from kubeflow_tpu_torch.models.bert import BertConfig, BertForMaskedLM, init_bert_params
from kubeflow_tpu_torch.models.convert import bert_params_from_flax
from kubeflow_tpu_torch.ops import flash_attention as fa
from kubeflow_tpu_torch.parallel.ring_attention import full_attention
from kubeflow_tpu_torch.runtime.metrics import METRICS

torch.set_num_threads(1)


@pytest.fixture(scope="module")
def flax_tree():
    params = JBert(JCfg.tiny()).init(jax.random.PRNGKey(0), jnp.zeros((1, 16), jnp.int32))
    return params["params"]


def _ids(b=3, L=24, vocab=1024, seed=0):
    return np.random.default_rng(seed).integers(0, vocab, (b, L)).astype(np.int32)


def _np_tree(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def _agree(a, b):
    return float((a.argmax(-1) == b.argmax(-1)).mean())


@pytest.mark.parametrize("dtype", ["f32", "bf16"])
def test_bert_tiny_logits_match_jax(flax_tree, dtype):
    jcfg, cfg = JCfg.tiny(), BertConfig.tiny()
    if dtype == "f32":
        jcfg = JCfg(**{**jcfg.__dict__, "dtype": jnp.float32})
        cfg = BertConfig(**{**cfg.__dict__, "dtype": torch.float32})
    ids = _ids()
    want = np.asarray(JBert(jcfg).apply({"params": flax_tree}, jnp.asarray(ids)))
    model = BertForMaskedLM.bind(cfg, bert_params_from_flax(_np_tree(flax_tree), cfg))
    with torch.no_grad():
        got = model(torch.as_tensor(ids)).numpy()
    assert got.dtype == np.float32 and got.shape == (3, 24, 1024)
    err = np.abs(got - want).max()
    if dtype == "f32":
        assert err <= 1e-4, err
    else:
        assert err <= 0.1, err
        assert _agree(got, want) >= 0.99


def test_converter_refuses_missing_extra_and_misshapen_leaves(flax_tree):
    cfg = BertConfig.tiny()
    tree = _np_tree(flax_tree)
    assert len(bert_params_from_flax(tree, cfg)) == len(BertForMaskedLM(cfg, device="meta")
                                                        .state_dict())
    missing = {**tree, "mlm_head": {"kernel": tree["mlm_head"]["kernel"]}}
    with pytest.raises(ValueError, match="missing"):
        bert_params_from_flax(missing, cfg)
    extra = {**tree, "pooler": {"kernel": np.zeros((64, 64), np.float32)}}
    with pytest.raises(ValueError, match="does not have"):
        bert_params_from_flax(extra, cfg)
    odd = {**tree, "mlm_transform": {**tree["mlm_transform"],
                                     "kernel": np.zeros((64, 32), np.float32)}}
    with pytest.raises(ValueError, match="does not fit"):
        bert_params_from_flax(odd, cfg)
    with pytest.raises(ValueError, match="does not fit"):
        bert_params_from_flax(tree, BertConfig(**{**cfg.__dict__, "vocab_size": 1000}))


@pytest.mark.parametrize("causal", [False, True])
@pytest.mark.parametrize("dtype", ["f32", "bf16"])
def test_full_attention_matches_jax(causal, dtype):
    rng = np.random.default_rng(3)
    q, k, v = (rng.standard_normal((2, 20, 4, 16)).astype(np.float32) for _ in range(3))
    jd, td = (jnp.float32, torch.float32) if dtype == "f32" else (jnp.bfloat16, torch.bfloat16)
    want = np.asarray(jax_full(*(jnp.asarray(x, jd) for x in (q, k, v)), causal=causal)
                      .astype(jnp.float32))
    got = full_attention(*(torch.as_tensor(x).to(td) for x in (q, k, v)), causal=causal)
    assert got.dtype == td
    atol = 1e-5 if dtype == "f32" else 1.6e-2  # bf16: one output rounding
    np.testing.assert_allclose(got.float().numpy(), want, rtol=0, atol=atol)


def test_auto_attention_on_the_cpu_is_full_attention_and_counts_nothing():
    rng = np.random.default_rng(4)
    before = METRICS.value("ops_fused_fallback_total", kernel="flash_attention")
    fa.reset_launches()
    for L in (128, 100):
        q, k, v = (torch.as_tensor(rng.standard_normal((1, L, 2, 32)).astype(np.float32))
                   for _ in range(3))
        for causal in (False, True):
            assert torch.equal(fa.auto_attention(q, k, v, causal=causal),
                               full_attention(q, k, v, causal=causal))
    assert METRICS.value("ops_fused_fallback_total", kernel="flash_attention") == before
    assert all(n == 0 for n in fa.LAUNCHES.values())


def test_bert_with_auto_attention_equals_full_attention_on_the_cpu():
    cfg = BertConfig.tiny()
    params = init_bert_params(cfg, seed=1, device="cpu")
    ids = torch.as_tensor(_ids(2, 16, seed=2))
    with torch.no_grad():
        a = BertForMaskedLM.bind(cfg, params, attention_fn=fa.auto_attention)(ids)
        b = BertForMaskedLM.bind(cfg, params)(ids)
    assert torch.equal(a, b)


def test_bert_served_model_matches_jax_servable():
    from kubeflow_tpu.serving.server import bert_served_model as jax_served
    from kubeflow_tpu_torch.serving.server import bert_served_model

    jmodel = jax_served(tiny=True)
    model = bert_served_model(tiny=True, device="cpu")
    assert model.input_dtype == torch.int32 and model.device.type == "cpu"
    model.params = bert_params_from_flax(_np_tree(jmodel.params), BertConfig.tiny())
    ids = _ids(3, 16, seed=5).tolist()
    got, want = np.asarray(model.predict(ids)), np.asarray(jmodel.predict(ids))
    assert got.shape == want.shape == (3, 16, 1024)
    assert np.abs(got - want).max() <= 0.1
    assert _agree(got, want) >= 0.99


def test_bert_params_are_seeded():
    cfg = BertConfig.tiny()
    a, b = init_bert_params(cfg, seed=4, device="cpu"), init_bert_params(cfg, seed=4, device="cpu")
    c = init_bert_params(cfg, seed=5, device="cpu")
    assert all(torch.equal(a[k], b[k]) for k in a)
    assert not torch.equal(a["mlm_head.weight"], c["mlm_head.weight"])


@pytest.mark.cuda
def test_auto_attention_on_the_card_takes_flash_at_any_length():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the flash kernels run only on the card")
    rng = np.random.default_rng(6)
    q, k, v = (torch.as_tensor(rng.standard_normal((2, 128, 4, 64)).astype(np.float32))
               .to("cuda", torch.bfloat16) for _ in range(3))
    before = METRICS.value("ops_fused_fallback_total", kernel="flash_attention")
    for L in (128, 100):
        fa.reset_launches()
        out = fa.auto_attention(q[:, :L], k[:, :L], v[:, :L])
        assert fa.LAUNCHES["flash_fwd"] == 1
        ref = full_attention(q[:, :L], k[:, :L], v[:, :L])
        assert (out.float() - ref.float()).abs().max().item() <= 2e-2
    assert METRICS.value("ops_fused_fallback_total", kernel="flash_attention") == before
