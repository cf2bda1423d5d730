"""The port's DynamicBatcher (kubeflow_tpu_torch/serving/batching.py) held to
the cases of tests/test_batching.py: coalescing, result routing, error
isolation, the latency bound, shutdown, and the HTTP integration
(concurrent predicts share one forward). Then ServedModel's batch-bucket
ladder against the JAX ServedModel's: the same answer for 3 rows, 413 for
129 on both."""

import threading
import time

import numpy as np
import pytest

import jax.numpy as jnp
import torch

from kubeflow_tpu.serving.server import ServedModel as JServedModel
from kubeflow_tpu_torch.serving.batching import DynamicBatcher
from kubeflow_tpu_torch.serving.server import ModelServer, ServedModel

torch.set_num_threads(1)


class CountingModel:
    """predict() that records calls and row counts; result = row * 10."""

    def __init__(self, delay: float = 0.0, fail_on=None):
        self.calls = []
        self.delay = delay
        self.fail_on = fail_on
        self.lock = threading.Lock()

    def predict(self, instances):
        with self.lock:
            self.calls.append(len(instances))
        if self.fail_on is not None and any(i == self.fail_on for i in instances):
            raise ValueError("poison row")
        if self.delay:
            time.sleep(self.delay)
        return [i * 10 for i in instances]


class TestDynamicBatcher:
    def test_single_request_roundtrip(self):
        m = CountingModel()
        b = DynamicBatcher(m.predict, max_batch=8, max_wait_ms=1.0)
        assert b.predict([1, 2, 3]) == [10, 20, 30]
        b.close()

    def test_concurrent_requests_coalesce(self):
        m = CountingModel(delay=0.01)
        b = DynamicBatcher(m.predict, max_batch=64, max_wait_ms=30.0)
        results = {}

        def client(i):
            results[i] = b.predict([i])

        threads = [threading.Thread(target=client, args=(i,)) for i in range(8)]
        for t in threads:
            t.start()
        for t in threads:
            t.join()
        assert results == {i: [i * 10] for i in range(8)}  # exact routing
        # fewer forwards than requests = coalescing happened
        assert len(m.calls) < 8, m.calls
        assert sum(m.calls) == 8

    def test_max_batch_caps_combined_rows(self):
        m = CountingModel(delay=0.05)
        b = DynamicBatcher(m.predict, max_batch=4, max_wait_ms=50.0)
        threads = [threading.Thread(target=lambda: b.predict([0, 0])) for _ in range(6)]
        for t in threads:
            t.start()
        for t in threads:
            t.join()
        assert all(c <= 4 for c in m.calls), m.calls

    def test_oversized_request_bypasses_queue(self):
        m = CountingModel()
        b = DynamicBatcher(m.predict, max_batch=4, max_wait_ms=5.0)
        out = b.predict(list(range(10)))
        assert out == [i * 10 for i in range(10)]
        b.close()

    def test_latency_bound_without_load(self):
        m = CountingModel()
        b = DynamicBatcher(m.predict, max_batch=1024, max_wait_ms=20.0)
        t0 = time.perf_counter()
        b.predict([1])
        elapsed = time.perf_counter() - t0
        assert elapsed < 1.0, f"single request waited {elapsed}s"
        b.close()

    def test_batch_failure_routes_to_all_members_and_recovers(self):
        m = CountingModel(fail_on=99)
        b = DynamicBatcher(m.predict, max_batch=8, max_wait_ms=1.0)
        with pytest.raises(ValueError, match="poison"):
            b.predict([99])
        # batcher survives and serves the next request
        assert b.predict([1]) == [10]
        b.close()

    def test_mixed_shapes_do_not_poison_each_other(self):
        """Two valid requests with different instance shapes must both
        succeed — only like-shaped requests share a combined array."""
        import numpy as np

        def predict(instances):
            arr = np.asarray(instances)  # raises on ragged input
            return [row.tolist() for row in arr]

        b = DynamicBatcher(predict, max_batch=16, max_wait_ms=20.0)
        results = {}
        threads = [
            threading.Thread(target=lambda: results.update(a=b.predict([[1.0]]))),
            threading.Thread(target=lambda: results.update(bb=b.predict([[1.0, 2.0]]))),
        ]
        for t in threads:
            t.start()
        for t in threads:
            t.join()
        assert results["a"] == [[1.0]] and results["bb"] == [[1.0, 2.0]]
        # a ragged request fails alone, at enqueue time
        with pytest.raises(ValueError):
            b.predict([[1.0], [1.0, 2.0]])
        b.close()

    def test_object_dtype_instances_serve_unbatched(self):
        """List-of-dict instances (models with a preprocess fn) produce
        object-dtype arrays with no structural signature: they must NOT
        co-batch (one malformed request would fail strangers' requests,
        breaking the fails-ALONE contract — ADVICE r1), and must still be
        served, alone."""
        calls = []

        def predict(instances):
            calls.append(list(instances))
            if any(not isinstance(i, dict) or "x" not in i for i in instances):
                raise ValueError("malformed")
            return [i["x"] * 2 for i in instances]

        b = DynamicBatcher(predict, max_batch=16, max_wait_ms=50.0)
        results = {}
        errors = {}

        def run(key, payload):
            try:
                results[key] = b.predict(payload)
            except Exception as e:  # noqa: BLE001
                errors[key] = e

        threads = [
            threading.Thread(target=run, args=("good", [{"x": 2}])),
            threading.Thread(target=run, args=("bad", [{"y": 1}])),
        ]
        for t in threads:
            t.start()
        for t in threads:
            t.join()
        assert results["good"] == [4]
        assert isinstance(errors["bad"], ValueError)
        # Never combined into one predict call.
        assert all(len(c) == 1 for c in calls)
        b.close()

    def test_closed_batcher_rejects(self):
        b = DynamicBatcher(lambda x: x, max_batch=8)
        b.close()
        with pytest.raises(RuntimeError, match="closed"):
            b.predict([1])

    def test_closed_batcher_rejects_immediately(self):
        """The rejection must not wait out a coalescing window: with a huge
        max_wait_ms, a post-close predict still fails instantly."""
        b = DynamicBatcher(lambda x: x, max_batch=8, max_wait_ms=10_000.0)
        b.close()
        t0 = time.perf_counter()
        with pytest.raises(RuntimeError, match="closed"):
            b.predict([1])
        assert time.perf_counter() - t0 < 1.0

    def test_interleaved_shapes_served_within_two_rounds(self):
        """Queue A, B, A, B (two shapes): round 1 serves one shape, the
        leftover shape is marked waited and round 2 serves it IMMEDIATELY
        (no second coalescing window). Nothing is dropped, and no batch
        mixes shapes."""
        calls = []
        lock = threading.Lock()

        def predict(instances):
            arr = np.asarray(instances)  # raises if shapes were mixed
            with lock:
                calls.append(arr.shape)
            return [row.tolist() for row in arr]

        b = DynamicBatcher(predict, max_batch=16, max_wait_ms=100.0)
        results = {}

        def run(key, payload):
            results[key] = b.predict(payload)

        payloads = {"a1": [[1.0]], "b1": [[1.0, 2.0]],
                    "a2": [[3.0]], "b2": [[3.0, 4.0]]}
        t0 = time.perf_counter()
        threads = [threading.Thread(target=run, args=(k, v))
                   for k, v in payloads.items()]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=10)
        elapsed = time.perf_counter() - t0
        assert results == payloads, results  # every pending served, routed right
        # each shape co-batched homogeneously (asarray would have raised)
        assert all(shape[1] in (1, 2) for shape in calls), calls
        # leftover shape served without a second full window: well under
        # 2x the 100 ms window even on a loaded CI box
        assert elapsed < 1.0, f"{elapsed}s for two rounds ({calls})"

    def test_close_wakes_every_waiter_and_fails_leftovers(self):
        """close() against a wedged predict_fn: the join times out, and the
        still-queued pending must be failed (BatcherClosed) rather than left
        blocked on done.wait() forever; the in-flight batch still completes
        once the model unwedges."""
        from kubeflow_tpu_torch.serving.batching import BatcherClosed

        release = threading.Event()

        def predict(instances):
            if np.asarray(instances).shape[1:] == (1,):  # only shape-A wedges
                release.wait(timeout=30)
            return [i for i in instances]

        b = DynamicBatcher(predict, max_batch=4, max_wait_ms=5.0)
        outcome = {}

        def run(key, payload):
            try:
                outcome[key] = b.predict(payload)
            except BaseException as e:  # noqa: BLE001
                outcome[key] = e

        t_a = threading.Thread(target=run, args=("a", [[1.0]]))
        t_a.start()
        time.sleep(0.2)  # worker takes A and wedges inside predict
        t_b = threading.Thread(target=run, args=("b", [[1.0, 2.0]]))
        t_b.start()
        time.sleep(0.2)  # B queued behind the wedged round
        b.close()  # join times out (worker wedged) -> B must be failed
        t_b.join(timeout=5)
        assert not t_b.is_alive(), "queued waiter left hanging after close()"
        assert isinstance(outcome["b"], BatcherClosed), outcome.get("b")
        release.set()
        t_a.join(timeout=10)
        assert outcome["a"] == [[1.0]]


class TestServerIntegration:
    def test_http_concurrent_predicts_share_forwards(self):
        import json
        import urllib.request

        model = ServedModel(name="m", apply_fn=lambda params, batch: batch * 2.0, params=None,
                            device="cpu")
        # count predict() executions: each is one padded forward
        predict_calls = []
        real_predict = model.predict

        def counting_predict(instances):
            predict_calls.append(len(instances))
            return real_predict(instances)

        model.predict = counting_predict
        server = ModelServer(batching=True, max_wait_ms=25.0).add(model)
        http = server.serve(0)
        base = f"http://127.0.0.1:{http.port}"
        outs = {}

        def client(i):
            req = urllib.request.Request(
                base + "/v1/models/m:predict",
                json.dumps({"instances": [[float(i)]]}).encode(),
                {"content-type": "application/json"},
            )
            outs[i] = json.loads(urllib.request.urlopen(req, timeout=10).read())["predictions"]

        threads = [threading.Thread(target=client, args=(i,)) for i in range(6)]
        for t in threads:
            t.start()
        for t in threads:
            t.join()
        assert outs == {i: [[2.0 * i]] for i in range(6)}
        # fewer forwards than requests = requests actually coalesced
        assert len(predict_calls) < 6, predict_calls
        assert sum(predict_calls) == 6
        http.close()
        server.close()

    def test_max_batch_validated_against_buckets(self):
        with pytest.raises(ValueError, match="exceeds largest bucket"):
            ModelServer(batching=True, max_batch=1024)

    def test_model_reload_closes_old_batcher(self):
        model_a = ServedModel(name="m", apply_fn=lambda p, b: b, params=None, device="cpu")
        server = ModelServer(batching=True).add(model_a)
        old = server._batchers["m"]
        model_b = ServedModel(name="m", apply_fn=lambda p, b: b + 1.0, params=None,
                               device="cpu")
        server.add(model_b)
        with pytest.raises(RuntimeError, match="closed"):
            old.predict([np.zeros((1,))])
        assert server._batchers["m"] is not old
        server.close()


class TestServedModelLadder:
    @staticmethod
    def _pair(**kw):
        w = np.random.default_rng(0).standard_normal((4, 3)).astype(np.float32)
        calls = []

        def tapply(p, x):
            calls.append(tuple(x.shape))
            return torch.tanh(x @ p)

        port = ServedModel(name="m", apply_fn=tapply, params=torch.as_tensor(w),
                           device="cpu", **kw)
        jmodel = JServedModel(name="m", apply_fn=lambda p, x: jnp.tanh(x @ p),
                              params=jnp.asarray(w))
        return port, jmodel, calls

    def test_three_rows_pad_to_four_and_equal_jax(self):
        port, jmodel, calls = self._pair()
        x = np.random.default_rng(1).standard_normal((3, 4)).tolist()
        got = port.predict(x)
        assert calls == [(4, 4)]  # padded to the next bucket, rows 0..2 returned
        np.testing.assert_allclose(np.asarray(got), np.asarray(jmodel.predict(x)),
                                   rtol=0, atol=1e-6)
        assert len(got) == 3

    def test_over_the_largest_bucket_is_413_on_both(self):
        from kubeflow_tpu.web.http import HttpError as JHttpError
        from kubeflow_tpu_torch.web.http import HttpError

        port, jmodel, calls = self._pair()
        x = np.zeros((129, 4)).tolist()
        with pytest.raises(HttpError) as err:
            port.predict(x)
        with pytest.raises(JHttpError) as jerr:
            jmodel.predict(x)
        assert err.value.status == jerr.value.status == 413
        assert calls == []
        assert len(port.predict(np.zeros((128, 4)).tolist())) == 128

    def test_input_dtype_and_preprocess(self):
        seen = []

        def apply(p, x):
            seen.append(x.dtype)
            return x * 2

        ints = ServedModel(name="i", apply_fn=apply, params=None, input_dtype=torch.int32,
                           device="cpu")
        assert ints.predict([[1, 2], [3, 4]]) == [[2, 4], [6, 8]]
        pre = ServedModel(name="p", apply_fn=apply, params=None, device="cpu",
                          preprocess=lambda inst: np.asarray([[d["x"]] for d in inst]))
        assert pre.predict([{"x": 1.5}]) == [[3.0]]
        assert seen == [torch.int32, torch.float32]
        assert ServedModel(name="e", apply_fn=apply, params=None, device="cpu").predict([]) == []
