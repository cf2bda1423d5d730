"""kubeflow_tpu_torch/serving against kubeflow_tpu/serving, on the CPU.

The port's ContinuousBatcher (kv_kernel=True, which on CPU tensors runs the
kernels' plain versions) and the JAX ContinuousBatcher(kv_kernel=True)
(Pallas kernels in interpret mode) serve the same prompts with the same
converted weights; on the f32 config greedy tokens must be identical in
every cache layout (paged bf16, contiguous, int8). Then the engine's
serving contracts, the HTTP predict route, and the package's import
boundary.
"""

import json
import subprocess
import sys
import time
import urllib.error
import urllib.request
from pathlib import Path

import numpy as np
import pytest

import jax
import jax.numpy as jnp
import torch

from kubeflow_tpu.models.gpt import GptConfig as JCfg, GptLM as JLM
from kubeflow_tpu.serving.continuous import ContinuousBatcher as JBatcher
from kubeflow_tpu_torch.models.convert import params_from_flax
from kubeflow_tpu_torch.models.gpt import GptConfig, generate, init_params
from kubeflow_tpu_torch.ops import kv_cache as tkv
from kubeflow_tpu_torch.serving.continuous import ContinuousBatcher
from kubeflow_tpu_torch.serving.errors import DeadlineExceeded, FleetSaturated
from kubeflow_tpu_torch.serving.server import ModelServer, gpt_served_model

torch.set_num_threads(1)

SHAPE = dict(d_model=32, n_layers=2, n_heads=2, d_ff=64, max_seq=128, vocab_size=101)
PROMPT_LENS = (7, 12, 30, 5)
BUDGETS = (10, 6, 9, 20)
LAYOUTS = {"paged_bf16": dict(paged=True), "contiguous": dict(paged=False),
           "paged_int8": dict(paged=True, kv_dtype="int8")}


@pytest.fixture(scope="module")
def weights():
    jcfg = JCfg(**SHAPE, dtype=jnp.float32)
    tcfg = GptConfig(**SHAPE, dtype=torch.float32)
    params = JLM(jcfg).init(jax.random.PRNGKey(0), jnp.zeros((1, 8), jnp.int32))["params"]
    return jcfg, params, tcfg, params_from_flax(jax.tree_util.tree_map(np.asarray, params), tcfg)


def _prompts():
    rng = np.random.default_rng(1)
    return [rng.integers(0, 101, n).astype(np.int32) for n in PROMPT_LENS]


def _serve(engine):
    try:
        futs = [engine.submit(p, n) for p, n in zip(_prompts(), BUDGETS)]
        return [f.result(timeout=300) for f in futs]
    finally:
        engine.close()


@pytest.mark.parametrize("layout", sorted(LAYOUTS))
def test_engine_greedy_tokens_match_jax_engine(weights, layout):
    jcfg, jparams, tcfg, tparams = weights
    want = _serve(JBatcher(jcfg, jparams, slots=2, kv_kernel=True, **LAYOUTS[layout]))
    got = _serve(ContinuousBatcher(tcfg, tparams, slots=2, kv_kernel=True,
                                   device="cpu", **LAYOUTS[layout]))
    assert got == want
    assert [len(t) for t in got] == list(BUDGETS)


@pytest.mark.parametrize("layout", sorted(LAYOUTS))
def test_kernel_and_plain_writes_give_identical_tokens(weights, layout):
    """bf16 config: the kv_kernel=True write path and the plain path agree
    bit for bit, and the paged arena matches the contiguous cache."""
    _, _, _, tparams = weights
    cfg = GptConfig(**SHAPE)
    runs = [_serve(ContinuousBatcher(cfg, tparams, slots=3, kv_kernel=k, device="cpu",
                                     **LAYOUTS[layout])) for k in (True, False)]
    assert runs[0] == runs[1]
    if layout == "contiguous":
        paged = _serve(ContinuousBatcher(cfg, tparams, slots=3, device="cpu"))
        assert paged == runs[0]


def test_engine_matches_static_generate(weights):
    _, _, tcfg, tparams = weights
    want = [generate(tcfg, tparams, p[None], n, device="cpu")[0, len(p):].tolist()
            for p, n in zip(_prompts(), BUDGETS)]
    assert _serve(ContinuousBatcher(tcfg, tparams, slots=2, device="cpu")) == want


def test_eos_temperature_and_small_arena(weights):
    _, _, tcfg, tparams = weights
    p = _prompts()[0]
    eng = ContinuousBatcher(tcfg, tparams, slots=2, chunk=4, kv_blocks=4, seed=3,
                            device="cpu")
    try:
        full = eng.submit(p, 12).result(timeout=120)
        eos = eng.submit(p, 12, eos_id=full[3]).result(timeout=120)
        assert eos == full[:full.index(full[3]) + 1]
        sampled = [eng.submit(p, 12, temperature=1.0) for _ in range(3)]
        for f in sampled:
            toks = f.result(timeout=120)
            assert len(toks) == 12 and all(0 <= t < 101 for t in toks)
        with pytest.raises(ValueError, match="KV blocks"):
            eng.submit(p, 80)  # needs more blocks than the 4-block arena has
    finally:
        eng.close()


def test_deadline_shedding_drain_and_unsupported_options(weights):
    _, _, tcfg, tparams = weights
    p = _prompts()[1]
    eng = ContinuousBatcher(tcfg, tparams, slots=1, chunk=1, max_pending=2,
                            interactive_reserve=0.5, device="cpu")
    try:
        late = eng.submit(p, 4, deadline=time.monotonic() - 1)
        with pytest.raises(DeadlineExceeded):
            late.result(timeout=10)
        futs = [eng.submit(p, 40, priority="batch") for _ in range(4)]
        outcomes = []
        for f in futs:
            try:
                outcomes.append(len(f.result(timeout=120)))
            except FleetSaturated:
                outcomes.append("shed")
        assert "shed" in outcomes and 40 in outcomes
    finally:
        assert eng.drain(timeout=60) == []


def test_bad_spec_draft_and_role_raise_the_jax_value_errors(weights):
    """Speculative decoding and the roles are ported: a draft of another
    vocab or a shorter max_seq, an unknown role and a role without the
    paged arena raise JAX's ValueErrors on both packages."""
    jcfg, jparams, tcfg, tparams = weights
    cases = (("vocab", dict(vocab_size=99), {}), ("max_seq", dict(max_seq=64), {}),
             ("unified\\|prefill\\|decode", None, dict(role="router")),
             ("paged=True", None, dict(role="prefill", paged=False)))
    for match, draft, opts in cases:
        jkw, tkw = dict(opts), dict(opts)
        if draft is not None:
            jd = JCfg(**dict(SHAPE, **draft), dtype=jnp.float32)
            jkw["spec_draft"] = (jd, jparams)
            tkw["spec_draft"] = (GptConfig(**dict(SHAPE, **draft)), tparams)
        with pytest.raises(ValueError, match=match):
            JBatcher(jcfg, jparams, **jkw)
        with pytest.raises(ValueError, match=match):
            ContinuousBatcher(tcfg, tparams, device="cpu", **tkw)


def _post(port, body, path="/v1/models/gpt:predict"):
    req = urllib.request.Request(f"http://127.0.0.1:{port}{path}",
                                 data=json.dumps(body).encode(), method="POST",
                                 headers={"Content-Type": "application/json"})
    with urllib.request.urlopen(req, timeout=120) as resp:
        return json.loads(resp.read())


def test_model_server_predict_over_http():
    model = gpt_served_model(tiny=True, max_new_tokens=5, device="cpu")
    server = ModelServer().add(model)
    httpd = server.serve(0)
    try:
        with urllib.request.urlopen(f"http://127.0.0.1:{httpd.port}/healthz") as r:
            assert json.loads(r.read())["models"] == ["gpt"]
        with urllib.request.urlopen(f"http://127.0.0.1:{httpd.port}/v1/models/gpt") as r:
            assert json.loads(r.read())["model_version_status"][0]["state"] == "AVAILABLE"
        prompts = [[1, 2, 3, 4], [5, 6, 7, 8]]
        preds = _post(httpd.port, {"instances": prompts})["predictions"]
        assert [p[:4] for p in preds] == prompts and all(len(p) == 9 for p in preds)
        want = generate(model.cfg, model.params, np.asarray(prompts), 5, device="cpu")
        assert preds == want.tolist()
        with pytest.raises(urllib.error.HTTPError) as err:
            _post(httpd.port, {"instances": [[1] * 125]})
        assert err.value.code == 413
    finally:
        httpd.close()
        server.close()
    assert tkv.LAUNCHES["kv_block_update"] == 0  # CPU tensors: plain versions


def test_prompts_over_the_largest_bucket_take_the_static_path(weights):
    """With chunked prefill off (``prefill_chunk=0``), a prompt over the
    largest prefill bucket (256) takes the static generate() path, as the
    JAX GenerativeModel does: the port's predict returns the port's
    generate() tokens, which equal the JAX server's on the converted weights
    (f32 on both sides, tokens exact). A batch over the largest batch bucket
    still answers 413. The engine's submit takes such a prompt, and with the
    chunk 0 its future fails at admission, as JAX's does."""
    from kubeflow_tpu.serving.server import GenerativeModel as JModel
    from kubeflow_tpu_torch.serving.server import BATCH_BUCKETS, GenerativeModel
    from kubeflow_tpu_torch.web.http import HttpError

    _, jparams, _, tparams = weights
    jcfg = JCfg(**dict(SHAPE, max_seq=512), dtype=jnp.float32)
    cfg = GptConfig(**dict(SHAPE, max_seq=512), dtype=torch.float32)
    model = GenerativeModel(name="g", apply_fn=None, params=tparams, cfg=cfg,
                            max_new_tokens=3, prefill_chunk=0, device="cpu")
    prompt = (np.random.default_rng(6).integers(0, 101, (1, 300))).astype(np.int32)
    got = model.predict(prompt.tolist())
    assert model._engine is None  # served without the engine
    assert got == generate(cfg, tparams, prompt, 3, device="cpu").tolist()
    assert len(got[0]) == 303 and got[0][:300] == prompt[0].tolist()
    jmodel = JModel(name="g", apply_fn=None, params=jparams, cfg=jcfg,
                    max_new_tokens=3, prefill_chunk=0)
    try:
        assert got == jmodel.predict(prompt.tolist())
    finally:
        jmodel.close()
    too_many = np.repeat(prompt, BATCH_BUCKETS[-1] + 1, axis=0)
    with pytest.raises(HttpError) as err:
        model.predict(too_many.tolist())
    assert err.value.status == 413
    eng = ContinuousBatcher(cfg, tparams, slots=1, prefill_chunk=0, device="cpu")
    try:
        fut = eng.submit(prompt[0], 3)
        with pytest.raises(ValueError, match="largest prefill bucket"):
            fut.result(timeout=60)
    finally:
        eng.close()


def test_port_imports_no_jax():
    """Importing every module of the port leaves no jax, flax, optax,
    ml_dtypes, kubeflow_tpu or top-level e2e module loaded (the port's probes live in
    kubeflow_tpu_torch.e2e)."""
    root = Path(__file__).resolve().parents[1]
    mods = sorted(".".join(p.relative_to(root).with_suffix("").parts)
                  for p in (root / "kubeflow_tpu_torch").rglob("*.py"))
    code = (
        "import importlib, sys\n"
        f"for m in {mods!r}: importlib.import_module(m.removesuffix('.__init__'))\n"
        "bad = [k for k in sys.modules if k.split('.')[0] in ('jax', 'flax', 'jaxlib',"
        " 'optax', 'ml_dtypes')"
        " or k == 'kubeflow_tpu' or k.startswith('kubeflow_tpu.')"
        " or k == 'e2e' or k.startswith('e2e.')]\n"
        "print(len(sys.modules), bad)\n"
        "sys.exit(1 if bad else 0)\n")
    proc = subprocess.run([sys.executable, "-c", code], cwd=root, capture_output=True,
                          text=True, timeout=120)
    assert proc.returncode == 0, proc.stdout + proc.stderr
    assert len(mods) >= 130
    assert {"kubeflow_tpu_torch.api.meta", "kubeflow_tpu_torch.api.conversion",
            "kubeflow_tpu_torch.apiserver.backend", "kubeflow_tpu_torch.apiserver.store",
            "kubeflow_tpu_torch.apiserver.client", "kubeflow_tpu_torch.apiserver.remote",
            "kubeflow_tpu_torch.apiserver.server", "kubeflow_tpu_torch.apiserver.__main__",
            "kubeflow_tpu_torch.runtime.manager", "kubeflow_tpu_torch.runtime.reconcile",
            "kubeflow_tpu_torch.runtime.informer", "kubeflow_tpu_torch.runtime.bootstrap",
            "kubeflow_tpu_torch.scheduler.ledger", "kubeflow_tpu_torch.scheduler.flight",
            "kubeflow_tpu_torch.scheduler.core", "kubeflow_tpu_torch.controllers.builtin",
            "kubeflow_tpu_torch.scale.topology", "kubeflow_tpu_torch.scale.loadgen",
            "kubeflow_tpu_torch.e2e.trace_federation_driver"} <= set(mods)
    assert {"kubeflow_tpu_torch.monitoring.tsdb", "kubeflow_tpu_torch.monitoring.scrape",
            "kubeflow_tpu_torch.monitoring.rules", "kubeflow_tpu_torch.monitoring.plane",
            "kubeflow_tpu_torch.monitoring.traces", "kubeflow_tpu_torch.runtime.events",
            "kubeflow_tpu_torch.services.__init__", "kubeflow_tpu_torch.services.dashboard",
            "kubeflow_tpu_torch.e2e.monitoring_driver"} <= set(mods)
    assert {"kubeflow_tpu_torch.runtime.chaos", "kubeflow_tpu_torch.e2e._http",
            "kubeflow_tpu_torch.e2e.serving_driver",
            "kubeflow_tpu_torch.e2e.observability_driver",
            "kubeflow_tpu_torch.e2e.fleet_driver",
            "kubeflow_tpu_torch.e2e.overload_driver"} <= set(mods)
    assert {"kubeflow_tpu_torch.training.attribution", "kubeflow_tpu_torch.training.autotune",
            "kubeflow_tpu_torch.e2e.attribution_driver", "kubeflow_tpu_torch.gpu.env",
            "kubeflow_tpu_torch.training.elastic", "kubeflow_tpu_torch.training.heartbeat",
            "kubeflow_tpu_torch.monitoring.goodput", "kubeflow_tpu_torch.monitoring.stragglers",
            "kubeflow_tpu_torch.scheduler.gang", "kubeflow_tpu_torch.e2e.elastic_cluster",
            "kubeflow_tpu_torch.e2e.elastic_driver", "kubeflow_tpu_torch.e2e.goodput_driver",
            "kubeflow_tpu_torch.e2e.straggler_driver", "kubeflow_tpu_torch.entry",
            "kubeflow_tpu_torch.bench", "kubeflow_tpu_torch.hpo.suggest",
            "kubeflow_tpu_torch.hpo.earlystop", "kubeflow_tpu_torch.hpo.study",
            "kubeflow_tpu_torch.runtime.chaos", "kubeflow_tpu_torch.e2e.control_plane_driver",
            "kubeflow_tpu_torch.e2e.controlplane_scale_driver"} <= set(mods)


def test_params_are_seeded():
    cfg = GptConfig.tiny()
    a, b = init_params(cfg, seed=4, device="cpu"), init_params(cfg, seed=4, device="cpu")
    assert all(torch.equal(a[k], b[k]) for k in a)
