"""Serving probe on the card: the port of ``e2e/serving_bench.py``.

Four passes, with JAX's rows, keys, rounding and printed lines:

1. :func:`bench_bert_http` — BERT-base masked-LM predict over real HTTP
   (``ModelServer`` on a local port, ``/v1/models/<name>:predict``); batch
   buckets 1/8/32, per-request wall latency p50/p95/max and throughput.
   The response carries argmax token ids. Attention goes through
   ``ops.flash_attention.auto_attention`` (the flash kernels on the card).
2. :func:`bench_gpt_decode` — GPT-medium static decoding (``generate()``:
   a 128-token prompt, then single-token steps over the scalar-cursor
   cache), decode tokens/s at batch 1 and 8.
3. :func:`bench_continuous` — mixed budgets (cycling 32/64/128/224) through
   the static path (groups of ``slots`` in lockstep to the group max, an
   offline oracle) and the continuous engine on the same requests; then a
   speculative pass on a distilled (or truncated self-) draft.
4. :func:`bench_disagg` — two models over an ``EngineFleet`` with a
   prefill pool and a decode pool each, int8 KV by default, a 2:1 mix of
   64- and 384-token prompts.

JAX's environment switches keep their defaults: ``BENCH_PAGED`` (1),
``BENCH_KV_BLOCKS`` (0 = full), ``BENCH_PREFILL_CHUNK`` (engine default),
``BENCH_SPEC`` (1), ``BENCH_SPEC_K`` (4), ``BENCH_KV_DTYPE`` (bf16 for the
engine pass, int8 for the fleet), ``BENCH_DRAFT`` (``distill`` or
``self``), ``BENCH_DISTILL_STEPS`` (300), ``BENCH_DISAGG`` (1). Each
function also takes the sizes JAX hard-codes (the config, request counts,
new tokens, distillation steps), JAX's values by default, and ``device``.

Weights come from ``init_params``/``init_bert_params`` seeded as JAX seeds
its ``PRNGKey``; prompts are numpy draws from the seeds JAX gives
``jax.random`` (JAX's own draws cannot be reproduced without JAX). The
warm-up calls JAX makes to compile stay where JAX makes them: eager
PyTorch compiles nothing, but the first calls still build kernels and pick
cuBLAS algorithms.

``observe(stage, info)`` (optional) is called after each pass of
:func:`bench_continuous` (``static``, ``continuous``, ``distill`` or
``self_draft``, ``spec``) and :func:`bench_disagg` (``disagg``) with what the pass made:
tokens, the draft, the fleet's requests. The rows do not depend on it.

Run on the card: ``python -m kubeflow_tpu_torch.e2e.serving_bench``
(several minutes at the defaults). On the CPU call the functions with a
small ``cfg`` and ``device="cpu"``.
"""

from __future__ import annotations

import dataclasses
import json
import os
import statistics
import time
from typing import Any, Callable, Dict, List, Optional, Sequence

import numpy as np
import torch

from ..device import DeviceLike, resolve_device
from ..models.bert import BertConfig
from ..models.gpt import GptConfig

SEQ = 128

Observe = Optional[Callable[[str, Dict[str, Any]], None]]


def p95_index(n: int) -> int:
    """The p95 sample's index in ``n`` sorted latencies: with 40 samples a
    real p95 (index 37); a "p99" there would just be the max."""
    return min(n - 1, int(n * 0.95) - 1)


def rounded_or_zero(v: Optional[float], digits: int = 4) -> float:
    """A registry quantile, rounded; ``0.0`` when the histogram has no
    observation (``quantile`` gives None: no data is not zero latency, but
    the row keeps JAX's number)."""
    return round(v, digits) if v is not None else 0.0


def _medium(cfg: Optional[GptConfig], max_seq: int) -> GptConfig:
    """JAX's bench config (d 1024, 24 layers, 16 heads, d_ff 4096, vocab
    32000), or ``cfg``, at ``max_seq``."""
    return dataclasses.replace(cfg or GptConfig.base(), max_seq=max_seq)


def _prompt(seed: int, n: int, vocab: int) -> np.ndarray:
    return np.random.default_rng(seed).integers(0, vocab, n).astype(np.int32)


def bench_bert_http(batches: Sequence[int] = (1, 8, 32), requests_per_batch: int = 40, *,
                    cfg: Optional[BertConfig] = None,
                    device: DeviceLike = "cuda") -> List[Dict[str, Any]]:
    import urllib.request

    from ..models.bert import BertForMaskedLM, init_bert_params
    from ..ops.flash_attention import auto_attention
    from ..serving.server import ModelServer, ServedModel

    dev = resolve_device(device)
    cfg = cfg or BertConfig.base()  # base: 12 layers, hidden 768
    params = init_bert_params(cfg, seed=0, device=dev)
    model = BertForMaskedLM.bind(cfg, params, attention_fn=auto_attention)

    def apply_fn(p, ids):
        logits = model(ids)
        return torch.argmax(logits, dim=-1).to(torch.int32)  # serving-shaped output

    server = ModelServer()
    server.add(ServedModel(name="bert-base", apply_fn=apply_fn, params=params,
                           input_dtype=torch.int32, device=dev))
    httpd = server.app.serve(0)
    url = f"http://127.0.0.1:{httpd.port}/v1/models/bert-base:predict"

    rows = []
    try:
        rng_np = np.random.default_rng(0)
        for batch in batches:
            payload = json.dumps({
                "instances": rng_np.integers(0, cfg.vocab_size, (batch, SEQ)).tolist()
            }).encode()

            def request() -> float:
                t0 = time.perf_counter()
                req = urllib.request.Request(url, payload,
                                             {"content-type": "application/json"})
                with urllib.request.urlopen(req, timeout=120) as resp:
                    body = json.loads(resp.read())
                assert len(body["predictions"]) == batch
                return time.perf_counter() - t0

            request()  # warm: first calls of this bucket's shapes
            lat = sorted(request() for _ in range(requests_per_batch))
            p50 = statistics.median(lat)
            p95 = lat[p95_index(len(lat))]
            rows.append({
                "batch": batch,
                "p50_ms": round(p50 * 1e3, 1),
                "p95_ms": round(p95 * 1e3, 1),
                "max_ms": round(lat[-1] * 1e3, 1),
                "qps": round(1.0 / p50, 2),
                "sequences_per_sec": round(batch / p50, 1),
            })
    finally:
        httpd.close()
        server.close()
    return rows


def bench_gpt_decode(batches: Sequence[int] = (1, 8), prompt_len: int = 128,
                     new_tokens: int = 256, *, cfg: Optional[GptConfig] = None,
                     device: DeviceLike = "cuda") -> List[Dict[str, Any]]:
    from ..models.gpt import generate, init_params

    dev = resolve_device(device)
    cfg = _medium(cfg, prompt_len + new_tokens)
    params = init_params(cfg, seed=0, device=dev)

    rows = []
    for batch in batches:
        # one seed for every batch, as JAX draws each from PRNGKey(0)
        prompt = np.random.default_rng(0).integers(
            0, cfg.vocab_size, (batch, prompt_len)).astype(np.int32)
        generate(cfg, params, prompt, new_tokens, device=dev).cpu()  # warm, fetch barrier
        t0 = time.perf_counter()
        generate(cfg, params, prompt, new_tokens, device=dev).cpu()
        dt = time.perf_counter() - t0
        rows.append({
            "batch": batch,
            "wall_s": round(dt, 3),
            "decode_tokens_per_sec": round(batch * new_tokens / dt, 1),
            "ms_per_token": round(dt / new_tokens * 1e3, 2),
        })
    return rows


def bench_continuous(slots: int = 8, n_requests: int = 16, prompt_len: int = 128,
                     chunk: int = 16, pipeline: int = 3, *,
                     budgets: Sequence[int] = (32, 64, 128, 224),
                     cfg: Optional[GptConfig] = None,
                     distill_steps: Optional[int] = None, observe: Observe = None,
                     device: DeviceLike = "cuda") -> Dict[str, Any]:
    """Mixed-budget decode workload: continuous batching vs the static
    batch path on the SAME requests. Budgets cycle ``budgets``: the static
    path groups ``slots`` requests per batch and every member pays the
    group max (lockstep decode); the engine retires each sequence at its
    budget and admits the next from the queue. The switches are the
    module docstring's; ``distill_steps`` (default ``BENCH_DISTILL_STEPS``)
    trains the distilled draft outside the timed window."""
    from ..models.gpt import generate, init_params
    from ..runtime.metrics import METRICS
    from ..serving.continuous import ContinuousBatcher
    from ..training.distill import distill_draft, draft_config, init_from_target

    dev = resolve_device(device)
    cycle = tuple(int(b) for b in budgets)
    budgets = [cycle[i % len(cycle)] for i in range(n_requests)]
    cfg = _medium(cfg, prompt_len + max(budgets))
    params = init_params(cfg, seed=0, device=dev)
    prompts = [_prompt(i, prompt_len, cfg.vocab_size) for i in range(n_requests)]
    total_tokens = sum(budgets)

    # -- static path: batches of `slots`, lockstep to the group max --------
    # warm the per-budget generate() calls outside the window. This path is
    # an OFFLINE ORACLE: it assumes every request is known upfront
    for b in sorted(set(budgets)):
        generate(cfg, params, np.stack([prompts[0]] * min(slots, n_requests)), b,
                 device=dev).cpu()
    t0 = time.perf_counter()
    static_done_at = [0.0] * n_requests
    outs = []
    for lo in range(0, n_requests, slots):
        group = list(range(lo, min(lo + slots, n_requests)))
        group_max = max(budgets[i] for i in group)
        batch = np.stack([prompts[i] for i in group])
        out = generate(cfg, params, batch, group_max, device=dev).cpu()  # fetch barrier
        for i in group:  # every member waits for the group max (lockstep)
            static_done_at[i] = time.perf_counter() - t0
        outs.append((group, out))
    static_s = time.perf_counter() - t0
    if observe is not None:
        tokens = {i: out[row, prompt_len:prompt_len + budgets[i]].tolist()
                  for group, out in outs for row, i in enumerate(group)}
        observe("static", {"cfg": cfg, "params": params, "prompts": prompts,
                           "budgets": budgets, "tokens": [tokens[i] for i in range(n_requests)]})

    # -- continuous path: same requests through the slot engine ------------
    paged = os.environ.get("BENCH_PAGED", "1") == "1"
    kv_blocks = int(os.environ.get("BENCH_KV_BLOCKS", "0") or 0) or None
    pc_env = os.environ.get("BENCH_PREFILL_CHUNK", "")
    prefill_chunk = int(pc_env) if pc_env else None
    kv_dtype = os.environ.get("BENCH_KV_DTYPE", "bf16")
    eng = ContinuousBatcher(cfg, params, slots=slots, chunk=chunk, pipeline=pipeline,
                            paged=paged, kv_blocks=kv_blocks, prefill_chunk=prefill_chunk,
                            kv_dtype=kv_dtype, device=dev)
    try:
        # warm the engine's paths (every admission-group size, a decode
        # chunk) as the static path's generate() calls are warmed above
        eng.prewarm(prompt_len)
        t0 = time.perf_counter()
        futs = [eng.submit(prompts[i], budgets[i]) for i in range(n_requests)]
        for f in futs:
            f.result(timeout=1800)
        continuous_s = time.perf_counter() - t0
        cont_lat = [f.done_at - t0 for f in futs]
    finally:
        eng.close()
    if observe is not None:
        observe("continuous", {"tokens": [list(f.tokens) for f in futs]})

    # SLO quantiles out of the engine's histograms (bucket interpolation,
    # what a /metrics scrape shows), read BEFORE the speculative pass adds
    # its own observations. prewarm() runs uninstrumented.
    def _q(name: str, q: float) -> float:
        return rounded_or_zero(METRICS.quantile(name, q))

    ttft_p50, ttft_p99 = _q("serving_ttft_seconds", 0.5), _q("serving_ttft_seconds", 0.99)
    queue_wait_p99 = _q("serving_queue_wait_seconds", 0.99)

    # -- speculative pass: distilled draft (default) or self-draft ---------
    spec: Dict[str, Any] = {}
    if os.environ.get("BENCH_SPEC", "1") == "1":
        spec_k = int(os.environ.get("BENCH_SPEC_K", "4"))
        draft_mode = os.environ.get("BENCH_DRAFT", "distill")
        if draft_mode == "distill":
            if distill_steps is None:
                distill_steps = int(os.environ.get("BENCH_DISTILL_STEPS", "300"))
            # trained OUTSIDE the timed window
            draft_cfg, draft_params = distill_draft(cfg, params, steps=distill_steps,
                                                    seed=0, device=dev)
        else:
            # the target's first n_layers // 4 blocks, its embeddings and
            # final norm
            draft_cfg = draft_config(cfg)
            draft_params = init_from_target(draft_cfg, params)
        draft_layers = draft_cfg.n_layers
        if observe is not None:
            observe("distill" if draft_mode == "distill" else "self_draft",
                    {"draft_cfg": draft_cfg, "draft_params": draft_params,
                     "steps": distill_steps})
        drafted0 = METRICS.counter("serving_spec_tokens_drafted_total").value
        accepted0 = METRICS.counter("serving_spec_tokens_accepted_total").value
        seng = ContinuousBatcher(cfg, params, slots=slots, chunk=chunk, pipeline=pipeline,
                                 paged=paged, kv_blocks=kv_blocks,
                                 prefill_chunk=prefill_chunk, kv_dtype=kv_dtype,
                                 spec_draft=(draft_cfg, draft_params), spec_k=spec_k,
                                 device=dev)
        try:
            seng.prewarm(prompt_len)
            t0 = time.perf_counter()
            sfuts = [seng.submit(prompts[i], budgets[i]) for i in range(n_requests)]
            for f in sfuts:
                f.result(timeout=1800)
            spec_s = time.perf_counter() - t0
        finally:
            seng.close()
        drafted = METRICS.counter("serving_spec_tokens_drafted_total").value - drafted0
        accepted = METRICS.counter("serving_spec_tokens_accepted_total").value - accepted0
        if observe is not None:
            observe("spec", {"tokens": [list(f.tokens) for f in sfuts],
                             "draft_layers": draft_layers, "spec_k": spec_k})
        spec = {
            "spec_k": spec_k,
            "spec_draft": draft_mode,
            "spec_draft_layers": draft_layers,
            "spec_wall_s": round(spec_s, 2),
            "spec_tokens_per_sec": round(total_tokens / spec_s, 1),
            "spec_accept_rate": round(accepted / drafted, 4) if drafted else 0.0,
        }

    return {
        "ttft_p50": ttft_p50,
        "ttft_p99": ttft_p99,
        "queue_wait_p99": queue_wait_p99,
        "paged": paged,
        "kv_blocks": kv_blocks or "full",
        "kv_dtype": kv_dtype,
        "prefill_chunk": eng.prefill_chunk,
        **spec,
        "slots": slots, "requests": n_requests, "budgets": "/".join(map(str, cycle)),
        "useful_tokens": total_tokens,
        "static_wall_s": round(static_s, 2),
        "static_tokens_per_sec": round(total_tokens / static_s, 1),
        "static_mean_latency_s": round(sum(static_done_at) / n_requests, 2),
        "continuous_wall_s": round(continuous_s, 2),
        "continuous_tokens_per_sec": round(total_tokens / continuous_s, 1),
        "continuous_mean_latency_s": round(sum(cont_lat) / n_requests, 2),
        "speedup": round(static_s / continuous_s, 3),
    }


def bench_disagg(slots: int = 8, n_requests: int = 24, chunk: int = 16, pipeline: int = 3,
                 *, prompt_short: int = 64, prompt_long: int = 384, budget: int = 128,
                 cfg: Optional[GptConfig] = None, observe: Observe = None,
                 device: DeviceLike = "cuda") -> Dict[str, Any]:
    """Heterogeneous mix over a disaggregated fleet: two models, a prefill
    pool and a decode pool per model, chatty short-prompt decode
    interleaved with long prefills (every third request). The fleet runs
    ``BENCH_KV_DTYPE`` (default int8), routes on the request's model id
    and ships every prefill over the KV wire, so the aggregate decode
    tokens/s pays for routing, handoff and import. Rows:
    ``decode_tok_s_heterogeneous`` and ``kv_handoff_p99_s`` (bucket
    interpolation of ``serving_kv_handoff_seconds``, 0.0 with no
    observation). Disable with ``BENCH_DISAGG=0``."""
    from ..models.gpt import init_params
    from ..runtime.metrics import METRICS
    from ..serving.fleet import EngineFleet

    dev = resolve_device(device)
    cfg = _medium(cfg, prompt_long + budget)
    params = {"alpha": init_params(cfg, seed=0, device=dev),
              "beta": init_params(cfg, seed=1, device=dev)}
    kv_dtype = os.environ.get("BENCH_KV_DTYPE", "int8")
    fleet = EngineFleet(
        cfg, params["alpha"], max_replicas=4,
        pools={"prefill": 1, "decode": 2},
        models={mid: (cfg, p) for mid, p in params.items()},
        model_slo={"alpha": "interactive", "beta": "batch"},
        slots=slots, chunk=chunk, pipeline=pipeline, name="bench-disagg",
        engine_kwargs={"kv_dtype": kv_dtype, "prefill_chunk": prompt_short},
        device=dev)
    # the mix: 2/3 chatty decode, 1/3 long prefill, models alternating
    reqs = []
    for i in range(n_requests):
        plen = prompt_long if i % 3 == 2 else prompt_short
        reqs.append(("alpha" if i % 2 == 0 else "beta",
                     _prompt(100 + i, plen, cfg.vocab_size)))
    try:
        # warm both pools' paths for both prompt shapes, per model
        warm = []
        for mid in params:
            for plen in (prompt_short, prompt_long):
                w = fleet.submit(_prompt(plen, plen, cfg.vocab_size), 2, model=mid)
                w.result(timeout=1800)
                warm.append(w)
        t0 = time.perf_counter()
        futs = [fleet.submit(p, budget, model=mid) for mid, p in reqs]
        for f in futs:
            f.result(timeout=1800)
        wall = time.perf_counter() - t0
        ttfts = sorted(f.first_token_at - f.submit_at for f in futs)
    finally:
        fleet.close()
    if observe is not None:
        observe("disagg", {"requests": futs, "warm": warm, "cfg": cfg})
    handoff_p99 = METRICS.quantile("serving_kv_handoff_seconds", 0.99)
    return {
        "models": 2,
        "pools": {"prefill": 1, "decode": 2},
        "kv_dtype": kv_dtype,
        "requests": n_requests,
        "prompt_mix": f"{prompt_short}/{prompt_long}",
        "budget": budget,
        "wall_s": round(wall, 2),
        "decode_tok_s_heterogeneous": round(n_requests * budget / wall, 1),
        "ttft_p99_s": round(ttfts[min(len(ttfts) - 1, int(len(ttfts) * 0.99))], 4),
        "kv_handoff_p99_s": rounded_or_zero(handoff_p99),
    }


def main() -> int:
    bert = bench_bert_http()
    print(f"{'BERT-base predict (HTTP)':28s} {'p50':>8s} {'p95':>8s} {'max':>8s} {'seq/s':>8s}")
    for r in bert:
        print(f"  batch {r['batch']:<4d}                 {r['p50_ms']:7.1f}ms "
              f"{r['p95_ms']:7.1f}ms {r['max_ms']:7.1f}ms {r['sequences_per_sec']:8.1f}")
    gpt = bench_gpt_decode()
    print(f"{'GPT-medium KV-cache decode':28s} {'tok/s':>8s} {'ms/tok':>8s}")
    for r in gpt:
        print(f"  batch {r['batch']:<4d}                 {r['decode_tokens_per_sec']:8.1f} "
              f"{r['ms_per_token']:7.2f}")
    print(json.dumps({"metric": "bert_base_predict_http", "rows": bert, "unit": "ms/qps"}))
    print(json.dumps({"metric": "gpt_medium_kv_decode", "rows": gpt, "unit": "tokens_per_sec"}))
    cont = bench_continuous()
    print(f"{'Continuous vs static batching':28s} {cont['continuous_tokens_per_sec']:8.1f}"
          f" vs {cont['static_tokens_per_sec']:8.1f} tok/s ({cont['speedup']}x)")
    print(json.dumps({"metric": "gpt_continuous_batching", **cont,
                      "unit": "tokens_per_sec"}))
    if os.environ.get("BENCH_DISAGG", "1") == "1":
        dis = bench_disagg()
        print(f"{'Disagg heterogeneous mix':28s} "
              f"{dis['decode_tok_s_heterogeneous']:8.1f} tok/s "
              f"(handoff p99 {dis['kv_handoff_p99_s']}s)")
        print(json.dumps({"metric": "decode_tok_s_heterogeneous",
                          "value": dis["decode_tok_s_heterogeneous"],
                          "unit": "tokens_per_sec", **dis}))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
