"""Disaggregated serving e2e over real HTTP: the port of
``e2e/disagg_driver.py``.

Boots a ``ModelServer`` whose ``GenerativeModel`` runs an
``EngineFleet(pools={"prefill": 1, "decode": 2})`` multiplexing two models
("alpha" interactive, "beta" batch) with an int8 KV arena, then:

1. **Greedy parity per model, moved == never-moved** — HTTP completions
   for both models equal a unified single-engine int8 oracle that never
   exported anything: every request prefilled on one replica, shipped over
   the KV wire and decoded on another.
2. **Handoff counters live** — ``serving_kv_handoff_total`` and
   ``serving_kv_import_total`` advanced together, and the
   ``serving_kv_handoff_bytes``/``_seconds`` histograms hold one
   observation a handoff.
3. **Chatty TTFT unharmed by a long-prefill burst** — with four long
   prompts chunk-prefilling on the prefill replica, every chatty request's
   first token (``first_token_at``) comes before the burst's last.
4. **int8 halves KV bytes** — two engines with the same block count
   differ ~2x in arena bytes (head_dim 64: 2D/(D+4) = 1.88x).
5. **Zero drops through a decode-pool drain** — a decode replica is
   drained mid-burst; its queued imports re-import into the surviving one
   and every request still returns the oracle's completion.

``run(device=...)`` returns the report (JAX's keys); ``main`` prints it as
one JSON line and exits 0, or prints ``{"ok": false, "error": ...}`` and
exits 1. Weights are seeded ``init_params`` (seeds 0, 1 and 2, as JAX
seeds its ``PRNGKey``); prompts are JAX's (numpy, seed 18). On the CPU:
``run(device="cpu")``; on the card: ``python -m
kubeflow_tpu_torch.e2e.disagg_driver``.
"""

from __future__ import annotations

import json
import sys
import threading
from typing import Any, Dict

from ..device import DeviceLike
from .paged_kv_driver import _get, _metric_value, _post

POOLS = {"prefill": 1, "decode": 2}
SLOTS = 4
BUDGET = 16
PREFILL_CHUNK = 32
LONG_PROMPT = 160
LONG_BURST = 4
CHATTY = 4


def run(device: DeviceLike = "cuda") -> Dict[str, Any]:
    import numpy as np

    from ..models.gpt import GptConfig, init_params
    from ..runtime.metrics import METRICS
    from ..serving.continuous import ContinuousBatcher
    from ..serving.server import GenerativeModel, ModelServer

    cfg = GptConfig(vocab_size=512, d_model=64, n_layers=2, n_heads=4, d_ff=128, max_seq=256)
    params = {mid: init_params(cfg, seed=seed, device=device)
              for mid, seed in (("alpha", 0), ("beta", 1))}

    rng = np.random.default_rng(18)
    long_prompt = rng.integers(1, cfg.vocab_size, size=LONG_PROMPT).tolist()
    chatty_prompts = [rng.integers(1, cfg.vocab_size, size=8).tolist() for _ in range(CHATTY)]

    # never-moved oracles: unified engines with the SAME int8 arena — the
    # wire's contract is byte-identical output moved vs never-moved
    oracle_engines = {
        mid: ContinuousBatcher(cfg, p, slots=SLOTS, prefill_chunk=PREFILL_CHUNK,
                               kv_dtype="int8", engine_id=f"nm-{mid}", device=device)
        for mid, p in params.items()}
    _oracle_cache: dict = {}

    def oracle(mid: str, prompt: list) -> list:
        """Full sequence (prompt + completion), matching the HTTP shape."""
        key = (mid, tuple(prompt))
        if key not in _oracle_cache:
            toks = oracle_engines[mid].submit(
                np.asarray(prompt, np.int32), BUDGET).result(timeout=600)
            _oracle_cache[key] = list(prompt) + toks
        return _oracle_cache[key]

    model = GenerativeModel(
        name="gpt", apply_fn=None, params=params["alpha"], cfg=cfg,
        max_new_tokens=BUDGET, temperature=0.0, slots=SLOTS,
        prefill_chunk=PREFILL_CHUNK, kv_dtype="int8",
        # max_replicas bounds every pool: without headroom the decode pool
        # would be clamped to 1 a model and the drain would leave alpha
        # with no decode replica at all
        max_replicas=4,
        pools=dict(POOLS),
        mux_models={mid: (cfg, p) for mid, p in params.items()},
        model_slo={"alpha": "interactive", "beta": "batch"}, device=device)
    server = ModelServer()
    server.add(model)
    httpd = server.serve(0)
    base = f"http://127.0.0.1:{httpd.port}"
    url = f"{base}/v1/models/gpt:predict"
    report: Dict[str, Any] = {"ok": True}
    try:
        fleet = model.engine()
        assert fleet.pool_size("decode") == POOLS["decode"], \
            f"decode pool clamped: {fleet.pool_size('decode')}"
        # -- (0) bring every (pool, model) engine's paths up ----------------
        warm = []
        for mid in params:
            warm.append(fleet.submit(np.asarray(chatty_prompts[0], np.int32), BUDGET,
                                     model=mid))
            warm.append(fleet.submit(np.asarray(long_prompt, np.int32), BUDGET, model=mid))
        for w in warm:
            w.result(timeout=600)

        # -- (1) per-model greedy parity through the quantized wire ---------
        handoffs0 = _metric_value(_get(f"{base}/metrics").decode(), "serving_kv_handoff_total")
        n_http = 0
        for mid in params:
            for p in chatty_prompts:
                status, out = _post(url, {"instances": [p], "model": mid})
                assert status == 200, f"{mid} got {status}: {out}"
                assert out["predictions"][0] == oracle(mid, p), \
                    f"model {mid}: moved+quantized decode diverged from its oracle"
                n_http += 1
        # models must not alias: same prompt, different completions
        assert oracle("alpha", chatty_prompts[0]) != oracle("beta", chatty_prompts[0]), \
            "sanity: the two models must disagree for isolation to be tested"
        report["parity"] = {"requests": n_http, "models": sorted(params)}

        # -- (2) every exported KV frame was adopted ------------------------
        text = _get(f"{base}/metrics").decode()
        handoffs = _metric_value(text, "serving_kv_handoff_total")
        imports = _metric_value(text, "serving_kv_import_total")
        assert handoffs - handoffs0 >= n_http, \
            f"expected >= {n_http} handoffs, counter moved {handoffs - handoffs0}"
        assert imports == handoffs, \
            f"handoffs {handoffs} != imports {imports}: a frame leaked in flight"
        hb = METRICS.histogram_counts("serving_kv_handoff_bytes")
        hs = METRICS.histogram_counts("serving_kv_handoff_seconds")
        assert hb is not None and hb[2] == int(handoffs)
        assert hs is not None and hs[2] == int(handoffs)
        report["handoff"] = {"count": handoffs,
                             "pool_replicas": {"prefill": fleet.pool_size("prefill"),
                                               "decode": fleet.pool_size("decode")}}

        # -- (3) chatty TTFT survives a long-prefill burst: long prompts
        # chunk-prefill one at a time on the prefill replica while short
        # prompts batch through every admission cycle, and decode slots are
        # claimed only at handoff — so chatty requests submitted behind a
        # burst of long prefills jump the queue
        burst = [long_prompt] + [rng.integers(1, cfg.vocab_size, size=LONG_PROMPT).tolist()
                                 for _ in range(LONG_BURST - 1)]
        burst_refs = [oracle("alpha", p) for p in burst]
        long_reqs = [fleet.submit(np.asarray(p, np.int32), BUDGET, model="alpha")
                     for p in burst]
        chatty_reqs = [fleet.submit(np.asarray(p, np.int32), BUDGET, model="alpha")
                       for p in chatty_prompts[:3]]
        for r, ref in zip(long_reqs, burst_refs):
            assert r.result(timeout=600) == ref[LONG_PROMPT:]
        for i, r in enumerate(chatty_reqs):
            assert r.result(timeout=600) == oracle("alpha", chatty_prompts[i])[8:]
        last_long_first = max(r.first_token_at for r in long_reqs)
        burst_span = last_long_first - long_reqs[0].submit_at
        chatty_ttfts = [r.first_token_at - r.submit_at for r in chatty_reqs]
        for i, r in enumerate(chatty_reqs):
            assert r.first_token_at < last_long_first, \
                f"chatty[{i}] TTFT {chatty_ttfts[i]:.3f}s — first token " \
                f"arrived after the whole {LONG_BURST}-long burst " \
                f"({burst_span:.3f}s): shorts are FIFO-stuck behind prefill"
        report["ttft"] = {"long_burst_span_s": round(burst_span, 3),
                          "chatty_max_s": round(max(chatty_ttfts), 3)}

        # -- (4) int8 arena: ~2x KV slots per HBM byte ----------------------
        acct_cfg = GptConfig(vocab_size=64, d_model=64, n_layers=1, n_heads=1, d_ff=64,
                             max_seq=128)
        acct_params = init_params(acct_cfg, seed=2, device=device)
        arena_bytes, blocks = {}, {}
        for dt in ("bf16", "int8"):
            eng = ContinuousBatcher(acct_cfg, acct_params, slots=2, kv_dtype=dt,
                                    engine_id=f"acct-{dt}", device=device)
            try:
                blocks[dt] = _metric_value(_get(f"{base}/metrics").decode(),
                                           "serving_kv_blocks_free", replica=f"acct-{dt}")
                arena_bytes[dt] = sum(
                    leaf.nbytes for blk in eng.cache.values()
                    for name, leaf in blk["attention"].items() if name != "cursors")
            finally:
                eng.close()
        assert blocks["bf16"] == blocks["int8"] > 0, f"capacity parity broken: {blocks}"
        ratio = arena_bytes["bf16"] / arena_bytes["int8"]
        assert ratio >= 1.8, f"int8 arena saves only {ratio:.2f}x (want ~2x): {arena_bytes}"
        report["int8_hbm"] = {"blocks": blocks["int8"],
                              "bf16_bytes": arena_bytes["bf16"],
                              "int8_bytes": arena_bytes["int8"],
                              "slots_per_byte_gain": round(ratio, 3)}

        # -- (5) decode-pool drain drops nothing ----------------------------
        outs: list = [None] * 6

        def client(i: int) -> None:
            mid = "alpha" if i % 2 == 0 else "beta"
            p = chatty_prompts[i % CHATTY]
            outs[i] = (mid, p, _post(url, {"instances": [p], "model": mid}))

        threads = [threading.Thread(target=client, args=(i,)) for i in range(6)]
        for t in threads:
            t.start()
        victim = next(h for h in fleet.live_handles()
                      if h.role == "decode" and h.model_id == "alpha")
        fleet.drain_replica(victim.id, reason="e2e")
        for t in threads:
            t.join(timeout=600)
        assert not any(t.is_alive() for t in threads), "client threads hung"
        for i, (mid, p, (status, out)) in enumerate(outs):
            assert status == 200, f"drain burst [{i}] got {status}: {out}"
            assert out["predictions"][0] == oracle(mid, p), \
                f"drain burst [{i}] diverged — a request was dropped or moved wrong"
        assert not any(h.id == victim.id for h in fleet.live_handles()), \
            "drained decode replica must leave the fleet"
        report["drain"] = {"requests": len(outs),
                           "decode_pool_after": fleet.pool_size("decode")}
        return report
    finally:
        for eng in oracle_engines.values():
            eng.close()
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
