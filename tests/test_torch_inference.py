"""The port's ``inference.AnalysisPredictor`` against the JAX package's,
on the CPU, on the same saved directories.

- Parity: the MLP, ResNet-18 (class_dim 4, 32x32) and tiny BERT with
  flash attention of ``tests/torch_served_models.py``, saved by the JAX
  package over seeded weights; both predictors run the same seeded
  batches at B1 and B3, within 1e-5 (MLP) and 1e-4 (ResNet, BERT) of
  max |ref|. Also the single-file layout (``model_filename`` and
  ``params_filename``, read through ``AnalysisConfig(prog_file,
  params_file)``).
- The zero-copy handles (``copy_from_cpu``/``copy_to_cpu``, names,
  shapes), ``prepare``, ``clone`` sharing the scope and program (a
  clone sees a weight changed through the original) and running in
  threads, the unset-input error, the config's device choice (the GPU
  by default: without one the predictor raises rather than run on the
  CPU), and ``export_stablehlo`` raising ``NotImplementedError``.
"""
import threading

import numpy as np
import pytest
import torch

import jax.numpy as jnp
import paddle_tpu as J

import paddle_tpu_torch as T
from paddle_tpu_torch import inference as tinf

import torch_served_models as M


def _save_jax(d, kind, **kw):
    main, _, feeds, targets = M.build(J, kind)
    scope = J.Scope()
    for n, a in M.weights(main, np.random.default_rng(0)).items():
        scope.set(n, jnp.asarray(a))
    J.io.save_inference_model(d, feeds, targets, J.Executor(),
                              main_program=main, scope=scope, **kw)
    return feeds


@pytest.fixture(scope="module")
def saved(tmp_path_factory):
    cache = {}

    def get(kind):
        if kind not in cache:
            d = str(tmp_path_factory.mktemp(kind))
            cache[kind] = (d, _save_jax(d, kind))
        return cache[kind]
    return get


def cpu_config(*args):
    cfg = tinf.AnalysisConfig(*args)
    cfg.disable_gpu()
    return cfg


@pytest.mark.parametrize("kind", M.KINDS)
def test_predictor_matches_jax(saved, kind):
    d, feeds = saved(kind)
    jp = J.inference.create_predictor(J.inference.AnalysisConfig(d))
    tp = tinf.create_predictor(cpu_config(d))
    assert tp.get_input_names() == jp.get_input_names() == feeds
    assert tp.get_output_names() == jp.get_output_names()
    for i, B in enumerate((1, 3)):
        feed = M.feeds(kind, B, np.random.default_rng(10 + i))
        ref = jp.run([feed[n] for n in feeds])
        got = tp.run([feed[n] for n in feeds])
        assert len(got) == len(ref)
        for g, r in zip(got, ref):
            assert g.shape == r.shape and g.dtype == np.float32
            assert M.close(g, r, kind)


def test_single_file_layout_through_prog_and_params_file(tmp_path):
    d = str(tmp_path)
    feeds = _save_jax(d, "mlp", model_filename="model",
                      params_filename="params")
    feed = M.feeds("mlp", 4, np.random.default_rng(3))
    ref = J.inference.create_predictor(J.inference.AnalysisConfig(
        prog_file=f"{d}/model", params_file=f"{d}/params")).run(
        [feed[n] for n in feeds])
    cfg = cpu_config()
    cfg.set_model(f"{d}/model", f"{d}/params")
    got = tinf.create_paddle_predictor(cfg).run([feed[n] for n in feeds])
    assert M.close(got[0], ref[0], "mlp")


def test_handles_prepare_and_unset_input(saved):
    d, feeds = saved("bert")
    pred = tinf.AnalysisPredictor(cpu_config(d))
    with pytest.raises(ValueError, match="never set"):
        pred.run()
    feed = M.feeds("bert", 2, np.random.default_rng(4))
    for n in pred.get_input_names():
        h = pred.get_input_handle(n)
        h.copy_from_cpu(feed[n])
        assert h.shape() == list(feed[n].shape)
    assert pred.run() is True
    outs = [pred.get_output_handle(n).copy_to_cpu()
            for n in pred.get_output_names()]
    assert [o.shape for o in outs] == [(2, 64), (2, 2)]
    np.testing.assert_allclose(outs[1].sum(1), 1.0, rtol=1e-6)
    again = pred.run([feed[n] for n in feeds])
    for a, b in zip(again, outs):
        np.testing.assert_array_equal(a, b)
    assert pred.prepare({n: (3, M.S_BERT) for n in feeds}) is pred
    assert pred.cache_stats()["entries"] >= 1
    assert pred.get_input_tensor(feeds[0]) is pred.get_input_handle(feeds[0])


def test_clone_shares_weights_and_runs_in_threads(saved):
    d, feeds = saved("mlp")
    pred = tinf.AnalysisPredictor(cpu_config(d))
    clone = pred.clone()
    assert clone._scope is pred._scope
    assert clone.program() is pred.program()
    assert clone._exe is not pred._exe
    feed = M.feeds("mlp", 5, np.random.default_rng(5))
    ref = pred.run([feed["x"]])[0]
    outs = [None] * 4

    def work(i):
        p = pred.clone()
        outs[i] = p.run([feed["x"]])[0]

    threads = [threading.Thread(target=work, args=(i,)) for i in range(4)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=60)
    assert not any(t.is_alive() for t in threads)
    for o in outs:
        np.testing.assert_array_equal(o, ref)
    # a weight changed through the original is what the clone reads
    w = pred._scope.find_var("fc_1.w_0")
    pred._scope.set("fc_1.w_0", w * 3.0)
    assert not np.allclose(clone.run([feed["x"]])[0], ref)


def test_device_defaults_to_the_gpu(saved):
    d, _ = saved("mlp")
    cfg = tinf.AnalysisConfig(d)
    assert cfg.use_gpu() and cfg.gpu_device_id() == 0
    assert isinstance(cfg.place(), T.CUDAPlace)
    cfg.disable_gpu()
    assert isinstance(cfg.place(), T.CPUPlace)
    cfg.enable_use_gpu(100, 0)
    assert isinstance(cfg.place(), T.CUDAPlace)
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="no CUDA device"):
            tinf.AnalysisPredictor(cfg)


def test_export_stablehlo_and_tensorrt_raise(saved):
    d, _ = saved("mlp")
    with pytest.raises(NotImplementedError, match="XLA"):
        tinf.export_stablehlo(d, {"x": (1, 16)})
    with pytest.raises(NotImplementedError):
        cpu_config(d).enable_tensorrt_engine()
