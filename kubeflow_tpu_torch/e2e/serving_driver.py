"""Serving e2e over real HTTP: the port of ``e2e/serving_driver.py``.

Serves BERT-tiny (seeded weights, ``bert_served_model``; attention through
``auto_attention``, the flash kernels on the card) behind ``ModelServer``
on port 0, then:

1. ``GET /v1/models/bert`` reports the model AVAILABLE (retried up to
   ``retries`` times, as the reference retries against a Service);
2. ``POST /v1/models/bert:predict`` with three 16-token instances returns
   three predictions within ``TOLERANCE`` of a direct ``model.predict`` of
   the same instances (the whole HTTP + padding path against the model);
3. a one-instance request, a smaller batch bucket, agrees with the first
   prediction within 5e-2 (the reference's cross-bucket tolerance).

``run_serving_e2e(device=...)`` returns ``{"predictions": 3, "model":
"bert"}``; ``main`` runs it as one JUnit case (``--junit``, default
``junit_serving.xml``; ``--device cpu`` for the CPU) and exits 1 on
failure. On the card: ``python -m
kubeflow_tpu_torch.e2e.serving_driver``.
"""

from __future__ import annotations

import sys
import urllib.error
from typing import Any, Dict, List

import numpy as np

from ..device import DeviceLike
from ._http import http_json, run_driver, run_with_retry

TOLERANCE = 1e-3  # the reference's almost_equal tolerance


def almost_equal(a: Any, b: Any, tol: float = TOLERANCE) -> bool:
    return bool(np.allclose(np.asarray(a), np.asarray(b), atol=tol))


def run_serving_e2e(retries: int = 10, device: DeviceLike = "cuda") -> Dict[str, Any]:
    from ..serving.server import ModelServer, bert_served_model

    model = bert_served_model("bert", tiny=True, device=device)
    server = ModelServer().add(model)
    http = server.serve(0)
    base = f"http://127.0.0.1:{http.port}"
    try:
        # golden predictions: the model applied directly, not over HTTP
        rng = np.random.default_rng(0)
        instances: List[List[int]] = rng.integers(0, 1000, size=(3, 16)).tolist()
        expected = model.predict(instances)

        status = run_with_retry(
            lambda: http_json("GET", f"{base}/v1/models/bert"),
            retries=retries, retry_on=(urllib.error.URLError, ConnectionError))
        assert status["model_version_status"][0]["state"] == "AVAILABLE", status

        resp = run_with_retry(
            lambda: http_json("POST", f"{base}/v1/models/bert:predict",
                              {"instances": instances}),
            retries=retries, retry_on=(urllib.error.URLError, ConnectionError))
        predictions = resp["predictions"]
        assert len(predictions) == len(instances), (len(predictions), len(instances))
        assert almost_equal(predictions, expected), \
            "served predictions diverge from direct apply"

        # a ragged batch: another bucket, so another padded shape, held at
        # the reference's relative tolerance
        resp1 = http_json("POST", f"{base}/v1/models/bert:predict",
                          {"instances": instances[:1]})
        assert np.allclose(np.asarray(resp1["predictions"][0]), np.asarray(expected[0]),
                           rtol=5e-2, atol=5e-2), \
            "padding changed predictions beyond accelerator numerics"
        return {"predictions": len(predictions), "model": "bert"}
    finally:
        http.close()


def main(argv=None) -> int:
    def add_args(parser):
        parser.add_argument("--device", default="cuda", choices=("cuda", "cpu"))

    return run_driver("e2e-serving", "ServingE2E", "bert-predict",
                      lambda args: lambda: run_serving_e2e(device=args.device), argv=argv,
                      add_args=add_args, default_junit="junit_serving.xml")


if __name__ == "__main__":
    sys.exit(main())
