"""Saved-model serving in the port, on the CPU: ``ServingEngine``, the
``MicroBatcher``, ``ExecutableCache`` and ``InferenceServer(model_dir)``.

- ``ServingEngine.execute`` on a group of requests equals
  ``Executor.run`` of the same padded batch bit for bit (the MLP,
  ResNet-18 and tiny BERT of ``tests/torch_served_models.py``), each
  request gets its own rows back (``_row_aligned``), and a batch-global
  fetch goes to every request whole.
- The ``MicroBatcher`` groups requests by per-example signature, flushes
  a group at once when it reaches ``max_batch_size`` rows and otherwise
  after ``batch_timeout_ms``, and fails what is still batching when it
  stops.
- ``InferenceServer(model_dir)`` with 8 concurrent ``Client.infer``
  callers: every reply within the served model's tolerance of
  ``AnalysisPredictor.run`` on that request alone. Not bit for bit:
  a request's rows run in a batch of another size, whose float sums may
  take another order (the JAX package's seed failure
  ``test_batched_results_bitwise_match_unbatched`` is this). The mean
  batch size is above 1, the cache hits, and it evicts at
  ``cache_entries=2``.
- Typed errors, in process and over the wire: a bad feed name or dtype
  (BadRequest), a full queue (Overloaded), a deadline, a stopped server
  (Shutdown).
- Warmup: a signature from the model's own feed specs that fails to
  capture raises; only an unreadable recorded-signature file warns.
- The CUDA-graph runner raises, rather than run eagerly, when asked for
  CUDA without a card; a replay adds its capture's kernel launches to
  the wrappers' counters.
"""
import os
import threading
import time

import numpy as np
import pytest
import torch

import paddle_tpu_torch as T
from paddle_tpu_torch import inference as tinf
from paddle_tpu_torch import kernels, serving
from paddle_tpu_torch.framework.cuda_graph import CapturedProgram
from paddle_tpu_torch.serving import (BadRequestError, Client,
                                      DeadlineExceededError, InferenceServer,
                                      MicroBatcher, Request, RequestQueue,
                                      ServerOverloadedError,
                                      ServerShutdownError, ServingEngine)

import torch_served_models as M

CPU = T.CPUPlace()


def _save(d, kind, extra_target=False):
    main, _, feeds, targets = M.build(T, kind)
    scope = T.Scope()
    for n, a in M.weights(main, np.random.default_rng(0)).items():
        scope.set(n, torch.from_numpy(a))
    if extra_target:
        with T.program_guard(main):
            targets = targets + [T.layers.mean(targets[0])]
    T.save_inference_model(d, feeds, targets, T.Executor(CPU),
                           main_program=main, scope=scope)
    return feeds


@pytest.fixture(scope="module")
def saved(tmp_path_factory):
    cache = {}

    def get(kind):
        if kind not in cache:
            d = str(tmp_path_factory.mktemp(kind))
            cache[kind] = (d, _save(d, kind))
        return cache[kind]
    return get


def _requests(kind, rows, seed=0):
    rng = np.random.default_rng(seed)
    return [Request(M.feeds(kind, r, rng)) for r in rows]


@pytest.mark.parametrize("kind", M.KINDS)
def test_execute_equals_executor_run_of_the_padded_batch(saved, kind):
    d, feeds = saved(kind)
    engine = ServingEngine(d, place=CPU)
    reqs = _requests(kind, (1, 2, 2))
    feed, rows, bucket = engine.pad_batch(reqs)
    assert (rows, bucket) == (5, 8)
    assert all(feed[n].shape[0] == 8 for n in feeds)
    ref = T.Executor(CPU).run(engine.program, feed=feed,
                              fetch_list=engine.fetch_names,
                              scope=engine.scope)
    engine.execute(reqs)
    off = 0
    for req in reqs:
        got = req.wait(timeout=1)
        for g, r in zip(got, ref):
            np.testing.assert_array_equal(g, r[off:off + req.rows])
        off += req.rows
    for g, r in zip(engine.run(feed), ref):
        np.testing.assert_array_equal(g, r)


def test_batch_global_fetch_is_replicated(tmp_path):
    d = str(tmp_path)
    _save(d, "mlp", extra_target=True)
    engine = ServingEngine(d, place=CPU)
    # a 0-d mean: no leading dim in the IR, decided from the output
    assert engine._row_aligned == [True, None]
    reqs = _requests("mlp", (1, 3))
    engine.execute(reqs)
    a, b = (r.wait(timeout=1) for r in reqs)
    assert a[0].shape == (1, 4) and b[0].shape == (3, 4)
    np.testing.assert_array_equal(a[1], b[1])


class _Recorder:
    def __init__(self):
        self.batches = []

    def __call__(self, reqs):
        self.batches.append([r.rows for r in reqs])
        for r in reqs:
            r.set_result([r.rows])


def test_microbatcher_groups_by_signature_and_flushes_full_at_once():
    q = RequestQueue(max_depth=64)
    rec = _Recorder()
    mb = MicroBatcher(q, rec, max_batch_size=4, batch_timeout_ms=10_000)
    x = lambda r, w=16: {"x": np.zeros((r, w), np.float32)}  # noqa: E731
    reqs = [q.put(Request(x(1))), q.put(Request(x(1, 8))),
            q.put(Request(x(2))), q.put(Request(x(1)))]
    mb.start()
    for r in (reqs[0], reqs[2], reqs[3]):      # 4 rows of width 16: full
        assert r.wait(timeout=5) == [r.rows]
    assert rec.batches == [[1, 2, 1]]
    assert not reqs[1].done()                  # width 8 waits its timeout
    mb.stop()
    with pytest.raises(ServerShutdownError):
        reqs[1].wait(timeout=5)


def test_microbatcher_timeout_flush():
    q = RequestQueue(max_depth=64)
    rec = _Recorder()
    mb = MicroBatcher(q, rec, max_batch_size=64, batch_timeout_ms=20)
    reqs = [q.put(Request({"x": np.zeros((1, 4), np.float32)}))
            for _ in range(3)]
    t0 = time.monotonic()
    mb.start()
    for r in reqs:
        r.wait(timeout=5)
    assert time.monotonic() - t0 >= 0.015
    assert rec.batches == [[1, 1, 1]]
    mb.stop()


def test_queue_serves_higher_priority_first():
    q = RequestQueue(max_depth=8)
    x = {"x": np.zeros((1, 4), np.float32)}
    low = q.put(Request(x, priority="best_effort"))
    mid = q.put(Request(x, priority="batch"))
    high = q.put(Request(x))
    assert [q.get(0), q.get(0), q.get(0)] == [high, mid, low]
    with pytest.raises(ValueError, match="priority"):
        Request(x, priority="urgent")


@pytest.mark.parametrize("kind", ["mlp", "bert"])
def test_server_batches_concurrent_clients(saved, kind):
    d, feeds = saved(kind)
    cfg = tinf.AnalysisConfig(d)
    cfg.disable_gpu()
    pred = tinf.create_predictor(cfg)
    server = InferenceServer(d, place=CPU, max_batch_size=64,
                             batch_timeout_ms=20.0, queue_depth=256)
    server.start(warmup_batch_sizes=(1, 8))
    sent = {i: M.feeds(kind, 1 + i % 2, np.random.default_rng(20 + i))
            for i in range(8)}
    got, errors = {}, []

    def client(i):
        try:
            with Client(server.endpoint, timeout=60) as c:
                for j in range(8):
                    got[(i, j)] = c.infer(sent[i])
        except Exception as e:  # noqa: BLE001 — reported below
            errors.append(e)

    threads = [threading.Thread(target=client, args=(i,)) for i in range(8)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=120)
    st = server.stats()
    server.stop()
    assert not errors and not any(t.is_alive() for t in threads)
    assert len(got) == 64
    for (i, _), outs in got.items():
        ref = pred.run([sent[i][n] for n in feeds])
        for g, r in zip(outs, ref):
            assert g.shape == r.shape
            assert M.close(g, r, kind)
    assert st["requests_completed"] == 64
    assert st["mean_batch_size"] > 1
    assert st["cache_hits"] >= 1 and st["compiles"] >= 2
    assert 0 < st["batch_occupancy"] <= 1
    assert st["execute_count"] == st["batches"]


def test_cache_evicts_at_its_entry_cap(saved):
    d, _ = saved("mlp")
    server = InferenceServer(d, place=CPU, cache_entries=2,
                             batch_timeout_ms=1.0)
    server.start(serve_network=False)
    x = np.random.default_rng(1).standard_normal((8, 16)).astype(np.float32)
    for rows in (1, 2, 4, 1):                     # buckets 1, 2, 4, 1
        server.infer({"x": x[:rows]}, timeout=30)
    st = server.stats()
    server.stop()
    assert st["cache_entries"] == 2 and st["cache_evictions"] == 2
    assert st["compiles"] == 4 and st["cache_misses"] == 4


def test_typed_errors(saved):
    d, _ = saved("mlp")
    server = InferenceServer(d, place=CPU, queue_depth=1)
    x = np.zeros((1, 16), np.float32)
    with pytest.raises(BadRequestError, match="unknown"):
        server.submit({"x": x, "y": x})
    with pytest.raises(BadRequestError, match="missing"):
        server.submit({})
    with pytest.raises(BadRequestError, match="float64"):
        server.submit({"x": x.astype(np.float64)})
    with pytest.raises(BadRequestError, match="shape"):
        server.submit({"x": np.zeros((1, 8), np.float32)})
    # the batcher is not running: the queue holds one request, then
    # refuses; a request whose deadline passes in the queue expires
    held = server.submit({"x": x}, deadline_ms=1.0)
    with pytest.raises(ServerOverloadedError, match="depth"):
        server.submit({"x": x})
    time.sleep(0.01)
    server.start()
    with pytest.raises(DeadlineExceededError):
        held.wait(timeout=10)
    with Client(server.endpoint, timeout=30) as c:
        with pytest.raises(BadRequestError, match="float64"):
            c.infer({"x": x.astype(np.float64)})
        with pytest.raises(BadRequestError, match="missing"):
            c.infer({"z": x})
        assert c.infer({"x": x})[0].shape == (1, 4)
        with pytest.raises(BadRequestError, match="generator"):
            c.generate(np.arange(3), 2)
    server.stop()
    with pytest.raises(ServerShutdownError):
        server.submit({"x": x})


def test_warmup_raises_on_model_signatures_and_warns_on_bad_file(
        saved, tmp_path, monkeypatch):
    d, _ = saved("mlp")
    engine = ServingEngine(d, place=CPU)
    assert engine.feed_specs(4) == {"x": ((4, 16), "float32")}
    assert engine.warmup(batch_sizes=(1, 3)) == 2      # buckets 1 and 4
    path = engine.record_signatures(str(tmp_path / "sigs.json"))
    fresh = ServingEngine(d, place=CPU)
    assert fresh.warmup(batch_sizes=(), signature_file=path) == 2
    assert sorted(fresh.cache.keys()) == sorted(engine.cache.keys())
    bad = tmp_path / "bad.json"
    bad.write_text("{not json")
    with pytest.warns(UserWarning, match="unreadable"):
        assert fresh.warmup(batch_sizes=(), signature_file=str(bad)) == 0

    def broken(feed):
        raise RuntimeError("capture failed")

    monkeypatch.setattr(fresh, "_compile", broken)
    with pytest.raises(RuntimeError, match="capture failed"):
        fresh.warmup(batch_sizes=(16,))


def test_graph_runner_raises_without_a_card(saved, monkeypatch):
    d, _ = saved("mlp")
    engine = ServingEngine(d, place=CPU)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    feed = {"x": np.zeros((2, 16), np.float32)}
    with pytest.raises(RuntimeError, match="needs a CUDA device"):
        CapturedProgram(engine._optimized, feed, engine.fetch_names,
                        engine.scope, "cuda")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        ServingEngine(d)                       # place None: the GPU
    with pytest.raises(RuntimeError, match="no CUDA device"):
        InferenceServer(d)


def test_replay_adds_the_captured_launches(saved):
    d, _ = saved("mlp")
    engine = ServingEngine(d, place=CPU)
    feed = {"x": np.ones((2, 16), np.float32)}
    entry = engine.entry_for(feed)
    fwd = kernels.flash_attention_fwd
    ref = entry.run(feed)

    class Graph:
        def replay(self):
            pass

    # a captured entry's replay: static buffers, outputs, its launches
    entry.graph = Graph()
    entry._bufs = {"x": torch.zeros(2, 16)}
    entry._outs = [torch.from_numpy(ref[0])]
    entry.replay_launches = {(fwd, "launches"): 12}
    before = fwd.launches
    for _ in range(3):
        np.testing.assert_array_equal(entry.run(feed)[0], ref[0])
    assert fwd.launches - before == 36
    fwd.launches = before
    np.testing.assert_array_equal(entry._bufs["x"].numpy(), feed["x"])
    assert serving.feed_signature(feed) in engine.cache


def test_unported_serving_entry_points_raise(saved, tmp_path):
    """The entry points that raised NotImplementedError before the
    resilience layer was ported now answer: a reload from a directory
    without a manifest and a snapshot missing a tensor raise typed
    errors, drain() drains, and a batcher restart leaves a live loop."""
    d, _ = saved("mlp")
    server = InferenceServer(d, place=CPU).start(serve_network=False)
    try:
        empty = str(tmp_path / "empty")
        os.makedirs(empty)
        with pytest.raises(T.resilience.CheckpointCorruptError,
                           match="manifest"):
            server.engine.load_state_snapshot(empty)
        with pytest.raises(ValueError, match="missing"):
            server.engine.swap_state({})
        with pytest.raises(T.resilience.CheckpointCorruptError):
            server.reload_weights(empty)
        server.batcher.restart()
        assert server.batcher.alive()
    finally:
        assert server.drain(timeout=10) == {"drained": True, "remaining": 0}
    assert server.state == "stopped"
