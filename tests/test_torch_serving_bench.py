"""kubeflow_tpu_torch/e2e/serving_bench.py against e2e/serving_bench.py, on the CPU.

The JAX bench hard-codes GPT-medium and BERT-base, which the CPU cannot
run in a test; its source is the reference instead. Its row keys are read
from its dict literals (``ast``), its p95 index, TTFT p99 index and
no-observation rule are evaluated from its own expressions, and its
truncated self-draft is rebuilt by its own statements. Each port function
runs at a tiny config on ``device="cpu"`` and must return exactly JAX's
keys under each ``BENCH_*`` setting tried; on f32 weights carried from a
JAX init, the static, continuous and speculative tokens equal JAX's
``generate()`` on the same prompts.
"""

import ast
import dataclasses
import json
from pathlib import Path

import numpy as np
import pytest

import jax
import jax.numpy as jnp
import torch

from kubeflow_tpu.models.gpt import GptConfig as JCfg, GptLM as JLM, generate as jgenerate
from kubeflow_tpu_torch.e2e import serving_bench as sb
from kubeflow_tpu_torch.models import gpt as tgpt
from kubeflow_tpu_torch.models.bert import BertConfig
from kubeflow_tpu_torch.models.convert import params_from_flax
from kubeflow_tpu_torch.models.gpt import GptConfig

torch.set_num_threads(1)

JAX_SOURCE = Path(__file__).resolve().parents[1] / "e2e" / "serving_bench.py"
SHAPE = dict(vocab_size=101, d_model=32, n_layers=4, n_heads=2, d_ff=64)
PROMPT_LEN = 8
BUDGETS = (4, 10)
SWITCHES = ("BENCH_PAGED", "BENCH_KV_BLOCKS", "BENCH_PREFILL_CHUNK", "BENCH_SPEC",
            "BENCH_SPEC_K", "BENCH_KV_DTYPE", "BENCH_DRAFT", "BENCH_DISTILL_STEPS",
            "BENCH_DISAGG")


@pytest.fixture(scope="module")
def jax_tree():
    return ast.parse(JAX_SOURCE.read_text())


def _function(tree, name):
    return next(n for n in ast.walk(tree) if isinstance(n, ast.FunctionDef) and n.name == name)


def _dict_keys(node):
    """String keys of every dict literal under ``node``, one set a literal."""
    return [{k.value for k in d.keys if isinstance(k, ast.Constant)}
            for d in ast.walk(node) if isinstance(d, ast.Dict)]


def _jax_keys(tree, func, with_spec=True):
    """The keys of the row dict(s) JAX's ``func`` builds."""
    sets = [s for s in _dict_keys(_function(tree, func)) if len(s) > 3]
    if func == "bench_continuous":
        ret, spec = max(sets, key=len), next(s for s in sets if "spec_k" in s)
        return ret | spec if with_spec else ret
    return max(sets, key=len)


def _jax_expr(tree, target):
    """The source of the expression JAX assigns to ``target``."""
    src = JAX_SOURCE.read_text()
    node = next(n for n in ast.walk(tree) if isinstance(n, ast.Assign)
                and any(isinstance(t, ast.Name) and t.id == target for t in n.targets))
    return ast.get_source_segment(src, node.value)


@pytest.fixture()
def clean_env(monkeypatch):
    for name in SWITCHES:
        monkeypatch.delenv(name, raising=False)
    return monkeypatch


@pytest.fixture(scope="module")
def carried():
    """A tiny f32 JAX GptLM init and the port's copy of it."""
    jcfg = JCfg(**SHAPE, max_seq=64, dtype=jnp.float32)
    jp = JLM(jcfg).init(jax.random.PRNGKey(0), jnp.zeros((1, 8), jnp.int32))["params"]
    cfg = GptConfig(**SHAPE, max_seq=64, dtype=torch.float32)
    return jcfg, jp, cfg, params_from_flax(jax.tree_util.tree_map(np.asarray, jp), cfg)


def _row_expr(path, tree, func, key):
    """The source of the value ``func``'s row dict gives ``key``, in
    parentheses (it may span lines)."""
    src = path.read_text()
    return next("(" + ast.get_source_segment(src, v) + ")" for d in ast.walk(_function(tree, func))
                if isinstance(d, ast.Dict) for k, v in zip(d.keys, d.values)
                if isinstance(k, ast.Constant) and k.value == key)


def test_p95_p99_and_no_observation_rules_equal_jax(jax_tree):
    p95 = _jax_expr(jax_tree, "p95")  # lat[min(len(lat) - 1, int(len(lat) * 0.95) - 1)]
    for n in range(1, 101):
        lat = list(range(n))
        assert lat[sb.p95_index(n)] == eval(p95, {"lat": lat, "min": min, "int": int})
    assert sb.p95_index(40) == 37 and sb.p95_index(8) == 6
    # bench_disagg's TTFT p99 and handoff p99 rows, each package's expression
    port_path = Path(sb.__file__)
    port_tree = ast.parse(port_path.read_text())
    names = {"min": min, "int": int, "len": len, "round": round}
    for key, var, values in (("ttft_p99_s", "ttfts", [[0.5], [0.1, 0.2, 0.3],
                                                      sorted(np.linspace(0, 1, 150))]),
                             ("kv_handoff_p99_s", "handoff_p99",
                              [None, 0.0, 0.123456, 2.5, 1e-6])):
        want, got = (_row_expr(path, tree, "bench_disagg", key)
                     for path, tree in ((JAX_SOURCE, jax_tree), (port_path, port_tree)))
        for v in values:
            scope = dict(names, **{var: v}, rounded_or_zero=sb.rounded_or_zero)
            assert eval(got, scope) == eval(want, scope), (key, v)
    # the engine pass's SLO rows: JAX's _q on the same registry values
    for v in (None, 0.0, 0.123456, 2.5, 1e-6):
        fake = type("M", (), {"quantile": staticmethod(lambda name, q, v=v: v)})
        ns = {"METRICS": fake, "round": round}
        exec(compile(ast.Module([_function(jax_tree, "_q")], []), "jax_q", "exec"), ns)
        assert sb.rounded_or_zero(v) == ns["_q"]("serving_ttft_seconds", 0.5)


def _tiny_continuous(monkeypatch, carried, seen, **kw):
    """bench_continuous at the tiny config on the carried weights."""
    _, _, cfg, tp = carried
    monkeypatch.setattr(tgpt, "init_params", lambda c, seed=0, device="cpu": tp)
    return sb.bench_continuous(slots=2, n_requests=2, prompt_len=PROMPT_LEN, chunk=2,
                               pipeline=1, budgets=BUDGETS, cfg=cfg, distill_steps=2,
                               observe=lambda stage, info: seen.__setitem__(stage, info),
                               device="cpu", **kw)


def test_self_draft_is_jax_truncated_draft(clean_env, carried, jax_tree):
    """BENCH_DRAFT=self: the draft JAX's statements build (the target's
    first n_layers // 4 blocks with its embeddings and final norm)."""
    jcfg, jp, cfg, tp = carried
    draft_layers = max(1, jcfg.n_layers // 4)
    jdraft = {k: v for k, v in jp.items() if not k.startswith("block_")}
    for i in range(draft_layers):
        jdraft[f"block_{i}"] = jp[f"block_{i}"]
    jdcfg = JCfg(d_model=jcfg.d_model, n_layers=draft_layers, n_heads=jcfg.n_heads,
                 d_ff=jcfg.d_ff, max_seq=jcfg.max_seq, vocab_size=jcfg.vocab_size)
    src = ast.get_source_segment(JAX_SOURCE.read_text(), _function(jax_tree, "bench_continuous"))
    assert "draft_layers = max(1, cfg.n_layers // 4)" in src
    clean_env.setenv("BENCH_DRAFT", "self")
    seen = {}
    row = _tiny_continuous(clean_env, carried, seen)
    dcfg, dparams = seen["self_draft"]["draft_cfg"], seen["self_draft"]["draft_params"]
    assert row["spec_draft_layers"] == draft_layers == 1
    for f in ("d_model", "n_layers", "n_heads", "d_ff", "vocab_size"):
        assert getattr(dcfg, f) == getattr(jdcfg, f), f
    assert dcfg.max_seq == PROMPT_LEN + max(BUDGETS)  # the bench's cfg, as JAX's
    want = params_from_flax(jax.tree_util.tree_map(np.asarray, jdraft),
                            dataclasses.replace(dcfg, dtype=torch.float32))
    assert sorted(dparams) == sorted(want)
    assert all(torch.equal(dparams[k], want[k]) for k in want)


def test_continuous_tokens_and_keys_equal_jax(clean_env, carried, jax_tree):
    """Defaults (paged bf16 arena, the spec pass on a distilled draft): JAX's
    keys; the static, continuous and speculative tokens equal JAX's
    greedy generate() on the same prompts and weights."""
    jcfg, jp, _, _ = carried
    seen = {}
    row = _tiny_continuous(clean_env, carried, seen)
    assert set(row) == _jax_keys(jax_tree, "bench_continuous")
    assert row["budgets"] == "4/10" and row["useful_tokens"] == 14
    assert row["spec_draft"] == "distill" and row["paged"] is True
    assert list(seen) == ["static", "continuous", "distill", "spec"]
    prompts = seen["static"]["prompts"]
    assert [p.tolist() for p in prompts] == [
        np.random.default_rng(i).integers(0, SHAPE["vocab_size"], PROMPT_LEN).tolist()
        for i in range(2)]
    jcfg64 = dataclasses.replace(jcfg, max_seq=PROMPT_LEN + max(BUDGETS))
    out = np.asarray(jgenerate(jcfg64, jp, jnp.asarray(np.stack(prompts)), max(BUDGETS)))
    want = [out[i, PROMPT_LEN:PROMPT_LEN + b].tolist() for i, b in enumerate(BUDGETS)]
    assert seen["static"]["tokens"] == want
    assert seen["continuous"]["tokens"] == want
    assert seen["spec"]["tokens"] == want


@pytest.mark.parametrize("env, spec", [
    ({"BENCH_PAGED": "0", "BENCH_SPEC": "0", "BENCH_PREFILL_CHUNK": "0"}, False),
    ({"BENCH_KV_DTYPE": "int8", "BENCH_DRAFT": "self", "BENCH_SPEC_K": "2",
      "BENCH_KV_BLOCKS": "40", "BENCH_PREFILL_CHUNK": "6"}, True),
], ids=["contiguous_no_spec", "int8_self_draft"])
def test_continuous_switches_keep_jax_keys(clean_env, carried, jax_tree, env, spec):
    for k, v in env.items():
        clean_env.setenv(k, v)
    seen = {}
    row = _tiny_continuous(clean_env, carried, seen)
    assert set(row) == _jax_keys(jax_tree, "bench_continuous", with_spec=spec)
    if spec:
        assert (row["spec_draft"], row["spec_k"], row["spec_draft_layers"]) == ("self", 2, 1)
        assert (row["kv_dtype"], row["kv_blocks"]) == ("int8", 40)
        assert list(seen) == ["static", "continuous", "self_draft", "spec"]
        # int8 KV tokens may differ from the f32 oracle; each request is whole
        assert [len(t) for t in seen["spec"]["tokens"]] == list(BUDGETS)
    else:
        assert (row["paged"], row["prefill_chunk"]) == (False, 0)
        assert seen["continuous"]["tokens"] == seen["static"]["tokens"]


def test_bert_and_decode_rows_keep_jax_keys(jax_tree):
    rows = sb.bench_bert_http(batches=(1, 2), requests_per_batch=3, cfg=BertConfig.tiny(),
                              device="cpu")
    assert [r["batch"] for r in rows] == [1, 2]
    assert all(set(r) == _jax_keys(jax_tree, "bench_bert_http") for r in rows)
    assert all(r["p50_ms"] <= r["p95_ms"] <= r["max_ms"] for r in rows)
    rows = sb.bench_gpt_decode(batches=(1, 2), prompt_len=8, new_tokens=3,
                               cfg=GptConfig.tiny(), device="cpu")
    assert [r["batch"] for r in rows] == [1, 2]
    assert all(set(r) == _jax_keys(jax_tree, "bench_gpt_decode") for r in rows)


def test_disagg_row_keeps_jax_keys(clean_env, jax_tree):
    seen = {}
    row = sb.bench_disagg(slots=2, n_requests=3, prompt_short=8, prompt_long=24, budget=3,
                          cfg=GptConfig.tiny(), device="cpu",
                          observe=lambda stage, info: seen.__setitem__(stage, info))
    assert set(row) == _jax_keys(jax_tree, "bench_disagg")
    assert row["kv_dtype"] == "int8" and row["prompt_mix"] == "8/24"
    assert row["pools"] == {"prefill": 1, "decode": 2} and row["kv_handoff_p99_s"] > 0
    reqs = seen["disagg"]["requests"]
    assert [r.finish_reason for r in reqs] == ["ok"] * 3
    assert all(r.submit_at <= r.first_token_at <= r.done_at for r in reqs)


def test_main_prints_jax_lines(clean_env, capsys):
    """main()'s JSON lines name JAX's metrics; BENCH_DISAGG=0 drops the fleet."""
    clean_env.setattr(sb, "bench_bert_http", lambda: [
        {"batch": 1, "p50_ms": 1.0, "p95_ms": 2.0, "max_ms": 3.0, "qps": 1.0,
         "sequences_per_sec": 1.0}])
    clean_env.setattr(sb, "bench_gpt_decode", lambda: [
        {"batch": 1, "wall_s": 1.0, "decode_tokens_per_sec": 2.0, "ms_per_token": 3.0}])
    clean_env.setattr(sb, "bench_continuous", lambda: {
        "continuous_tokens_per_sec": 2.0, "static_tokens_per_sec": 1.0, "speedup": 2.0})
    clean_env.setattr(sb, "bench_disagg", lambda: {
        "decode_tok_s_heterogeneous": 5.0, "kv_handoff_p99_s": 0.1})
    for disagg, metrics in (("1", ["bert_base_predict_http", "gpt_medium_kv_decode",
                                   "gpt_continuous_batching", "decode_tok_s_heterogeneous"]),
                            ("0", ["bert_base_predict_http", "gpt_medium_kv_decode",
                                   "gpt_continuous_batching"])):
        clean_env.setenv("BENCH_DISAGG", disagg)
        assert sb.main() == 0
        lines = [json.loads(x) for x in capsys.readouterr().out.splitlines()
                 if x.startswith("{")]
        assert [x["metric"] for x in lines] == metrics
