"""Paged-KV serving e2e over real HTTP: the port of ``e2e/paged_kv_driver.py``.

Boots a ``ModelServer`` hosting a GPT ``GenerativeModel`` (max_seq 512, so
prompts can exceed the largest prefill bucket) whose 2-replica engine
fleet runs the paged KV arena, chunked prefill (chunk 64) and a tiny
draft speculating ``spec_k`` 4 tokens a round, then:

1. **Greedy parity, short prompts** — HTTP completions equal the static
   ``generate()`` oracle, three times over.
2. **Over-bucket prompt via chunked prefill** — a 300-token prompt (past
   the largest prefill bucket, 256) returns 200 with the oracle's
   completion, and ``serving_prefill_chunks_total`` counts its chunks.
3. **Interactive latency holds during a long prefill** — chatty 8-token
   prompts posted while the 300-token prefill is in flight all return 200
   with the oracle's completions; then, on one engine, chatty requests
   submitted once the long prompt's first chunk has run (the worker held
   there: JAX sleeps 50 ms, which on a fast host can outlast the whole
   prefill) each get their first token (``first_token_at``) before the
   long request's, and so a shorter TTFT: chunked prefill interleaves them.
4. **Speculation is live** — ``serving_spec_tokens_drafted_total`` and
   ``serving_spec_tokens_accepted_total`` are both nonzero.
5. **Arena reclamation** — after the burst, ``serving_kv_blocks_used`` is
   back to zero and ``serving_kv_blocks_free`` is reported.

``run(device=...)`` returns the report (JAX's keys); ``main`` prints it
as one JSON line and exits 0, or prints ``{"ok": false, "error": ...}``
and exits 1. Weights are seeded ``init_params`` (seeds 0 and 1, as JAX
seeds its ``PRNGKey``); prompts are JAX's (numpy, seed 12). On the CPU:
``run(device="cpu")``; on the card: ``python -m
kubeflow_tpu_torch.e2e.paged_kv_driver``.
"""

from __future__ import annotations

import json
import sys
import threading
import time
import urllib.error
import urllib.request
from typing import Any, Dict

from ..device import DeviceLike

REPLICAS = 2
SLOTS = 4
BUDGET = 24
PREFILL_CHUNK = 64
SPEC_K = 4
LONG_PROMPT = 300  # past PREFILL_BUCKETS[-1] = 256 -> must chunk
CHATTY = 6


def _get(url: str) -> bytes:
    with urllib.request.urlopen(url, timeout=60) as resp:
        return resp.read()


def _post(url: str, body: dict, timeout: float = 300.0) -> tuple:
    """POST returning ``(status, parsed_body)``: 4xx/5xx are observations,
    not exceptions."""
    req = urllib.request.Request(
        url, json.dumps(body).encode(), {"content-type": "application/json"})
    try:
        with urllib.request.urlopen(req, timeout=timeout) as resp:
            return resp.status, json.loads(resp.read())
    except urllib.error.HTTPError as e:
        raw = e.read()
        try:
            parsed = json.loads(raw)
        except ValueError:
            parsed = {"raw": raw.decode(errors="replace")}
        return e.code, parsed


def _poll(fn, timeout: float = 30.0, interval: float = 0.05, desc: str = "condition"):
    deadline = time.monotonic() + timeout
    while time.monotonic() < deadline:
        value = fn()
        if value:
            return value
        time.sleep(interval)
    raise AssertionError(f"timed out after {timeout}s waiting for {desc}")


def _metric_value(text: str, name: str, **labels) -> float:
    """The sum of every sample of ``name`` whose labels include ``labels``
    in an exposition text."""
    total = 0.0
    for line in text.splitlines():
        if not line.startswith(name):
            continue
        rest = line[len(name):]
        if rest[:1] not in ("{", " "):
            continue
        if all(f'{k}="{v}"' in rest for k, v in labels.items()):
            total += float(line.split(" # ")[0].rsplit(" ", 1)[1])
    return total


class _FirstChunkGate:
    """Holds an engine's worker after its next prefill call (a chunked
    prompt's first chunk) until :meth:`remove`; ``reached`` is set there."""

    def __init__(self, engine) -> None:
        self.engine, self.real = engine, engine._prefill_model
        self.reached, self.release = threading.Event(), threading.Event()
        engine._prefill_model = self

    def __getattr__(self, name):
        return getattr(self.real, name)

    def __call__(self, *args, **kw):
        out = self.real(*args, **kw)
        self.engine._prefill_model = self.real  # one call only
        self.reached.set()
        self.release.wait(timeout=300)
        return out

    def remove(self) -> None:
        self.engine._prefill_model = self.real
        self.release.set()


def run(device: DeviceLike = "cuda") -> Dict[str, Any]:
    import numpy as np

    from ..models.gpt import GptConfig, generate, init_params
    from ..serving.server import GenerativeModel, ModelServer

    cfg = GptConfig(vocab_size=512, d_model=64, n_layers=2, n_heads=4, d_ff=128, max_seq=512)
    draft_cfg = GptConfig(vocab_size=512, d_model=32, n_layers=1, n_heads=2, d_ff=64,
                          max_seq=512)
    params = init_params(cfg, seed=0, device=device)
    draft_params = init_params(draft_cfg, seed=1, device=device)

    rng = np.random.default_rng(12)
    long_prompt = rng.integers(1, cfg.vocab_size, size=LONG_PROMPT).tolist()
    chatty_prompts = [rng.integers(1, cfg.vocab_size, size=8).tolist() for _ in range(CHATTY)]

    def oracle(prompt: list) -> list:
        out = generate(cfg, params, np.asarray([prompt], np.int32), BUDGET, device=device)
        return out[0].tolist()

    model = GenerativeModel(
        name="gpt", apply_fn=None, params=params, cfg=cfg,
        max_new_tokens=BUDGET, temperature=0.0,
        replicas=REPLICAS, slots=SLOTS,
        prefill_chunk=PREFILL_CHUNK,
        spec_draft=(draft_cfg, draft_params), spec_k=SPEC_K, device=device)
    server = ModelServer()
    server.add(model)
    httpd = server.serve(0)
    base = f"http://127.0.0.1:{httpd.port}"
    url = f"{base}/v1/models/gpt:predict"
    report: Dict[str, Any] = {"ok": True}
    try:
        # -- (0) bring every replica's paths up (the chatty bucket at every
        # group size, the chunked path) before anything is compared in time
        fleet = model.engine()
        for h in fleet.live_handles():
            h.engine.prewarm(8, timeout=300)
            h.engine.submit(np.asarray(long_prompt, np.int32),
                            max_new_tokens=BUDGET).result(timeout=300)

        # -- (1) greedy parity + determinism on short prompts ---------------
        short_ref = oracle(chatty_prompts[0])
        for _ in range(3):
            status, out = _post(url, {"instances": [chatty_prompts[0]]})
            assert status == 200, f"warmup got {status}: {out}"
            assert out["predictions"][0] == short_ref, \
                "paged+spec greedy decode must match the static oracle"

        # -- (2) over-bucket prompt serves through chunked prefill ----------
        long_ref = oracle(long_prompt)
        chunks_before = _metric_value(
            _get(f"{base}/metrics").decode(), "serving_prefill_chunks_total")
        t0 = time.monotonic()
        status, out = _post(url, {"instances": [long_prompt]})
        solo_long_s = time.monotonic() - t0
        assert status == 200, f"over-bucket prompt got {status}: {out}"
        assert out["predictions"][0] == long_ref, \
            "chunked prefill must be bit-identical to the static oracle"
        chunks_after = _metric_value(
            _get(f"{base}/metrics").decode(), "serving_prefill_chunks_total")
        min_chunks = LONG_PROMPT // PREFILL_CHUNK
        assert chunks_after - chunks_before >= min_chunks, \
            f"expected >= {min_chunks} prefill chunks, " \
            f"counter moved {chunks_after - chunks_before}"
        report["long_prompt"] = {"seconds": round(solo_long_s, 3),
                                 "chunks": chunks_after - chunks_before}

        # -- (3) chatty traffic stays exact while a long prefill is in flight
        chatty_refs = [oracle(p) for p in chatty_prompts]
        long_wall = [None]
        chatty_out: list = [None] * CHATTY

        def long_client() -> None:
            t = time.monotonic()
            long_wall[0] = (_post(url, {"instances": [long_prompt]}), time.monotonic() - t)

        def chatty_client(i: int) -> None:
            t = time.monotonic()
            chatty_out[i] = (_post(url, {"instances": [chatty_prompts[i]]}),
                             time.monotonic() - t)

        lt = threading.Thread(target=long_client)
        lt.start()
        time.sleep(0.05)  # let the long prefill admit first
        cts = [threading.Thread(target=chatty_client, args=(i,)) for i in range(CHATTY)]
        for t in cts:
            t.start()
        lt.join(timeout=300)
        for t in cts:
            t.join(timeout=300)
        assert not lt.is_alive() and not any(t.is_alive() for t in cts), "client threads hung"
        (l_status, l_out), l_seconds = long_wall[0]
        assert l_status == 200, f"long prompt under load got {l_status}"
        assert l_out["predictions"][0] == long_ref
        chatty_seconds = []
        for i, ((status, out), seconds) in enumerate(chatty_out):
            assert status == 200, f"chatty[{i}] got {status}: {out}"
            assert out["predictions"][0] == chatty_refs[i], \
                f"chatty[{i}] diverged from the static oracle under load"
            chatty_seconds.append(seconds)
        report["mixed"] = {
            "long_s": round(l_seconds, 3),
            "chatty_max_s": round(max(chatty_seconds), 3),
            "chatty_p50_s": round(sorted(chatty_seconds)[CHATTY // 2], 3)}

        # -- (3b) interactive TTFT holds on the replica running the prefill:
        # the long prompt and then chatty prompts on the SAME engine, the
        # chatty ones submitted once the long prompt's first chunk has run
        # (the worker held there, so the order does not hang on timing);
        # chunked prefill admits and decodes them between the remaining
        # chunks, so every chatty first token lands before the long one's
        h = fleet.live_handles()[0]
        gate = _FirstChunkGate(h.engine)
        try:
            long_req = h.engine.submit(np.asarray(long_prompt, np.int32),
                                       max_new_tokens=BUDGET)
            assert gate.reached.wait(timeout=300), "the long prompt never started prefill"
            chatty_reqs = [h.engine.submit(np.asarray(p, np.int32), max_new_tokens=BUDGET)
                           for p in chatty_prompts[:3]]
        finally:
            gate.remove()
        assert long_req.result(timeout=300) == long_ref[LONG_PROMPT:]
        for i, r in enumerate(chatty_reqs):
            assert r.result(timeout=300) == chatty_refs[i][8:]
        long_ttft = long_req.first_token_at - long_req.submit_at
        for i, r in enumerate(chatty_reqs):
            ttft = r.first_token_at - r.submit_at
            assert r.first_token_at < long_req.first_token_at and ttft < long_ttft, \
                f"chatty[{i}] TTFT {ttft:.3f}s >= long-prompt TTFT " \
                f"{long_ttft:.3f}s — prefill is not interleaving"
        report["ttft"] = {
            "long_s": round(long_ttft, 3),
            "chatty_max_s": round(max(r.first_token_at - r.submit_at
                                      for r in chatty_reqs), 3)}

        # -- (4) speculation actually ran -----------------------------------
        text = _get(f"{base}/metrics").decode()
        drafted = _metric_value(text, "serving_spec_tokens_drafted_total")
        accepted = _metric_value(text, "serving_spec_tokens_accepted_total")
        assert drafted > 0, "draft model never proposed a token"
        assert 0 < accepted <= drafted, f"accepted={accepted} drafted={drafted}"
        report["spec"] = {"drafted": drafted, "accepted": accepted,
                          "accept_rate": round(accepted / drafted, 3)}

        # -- (5) every KV block reclaimed after the burst -------------------
        def blocks_reclaimed():
            t = _get(f"{base}/metrics").decode()
            return _metric_value(t, "serving_kv_blocks_used") == 0.0

        _poll(blocks_reclaimed, timeout=30.0, desc="serving_kv_blocks_used to drain to zero")
        free = _metric_value(_get(f"{base}/metrics").decode(), "serving_kv_blocks_free")
        assert free > 0, "serving_kv_blocks_free gauge missing"
        report["kv_blocks_free_after_drain"] = free
        return report
    finally:
        httpd.close()
        server.close()
        model.close()


def main() -> int:
    try:
        report = run()
    except AssertionError as e:
        print(json.dumps({"ok": False, "error": str(e)}))
        return 1
    print(json.dumps(report))
    return 0


if __name__ == "__main__":
    sys.exit(main())
