"""Inference engine of the port: ``AnalysisConfig`` and
``AnalysisPredictor``.

Counterpart of ``paddle_tpu/inference/__init__.py``. A predictor loads a
saved inference model (``io.load_inference_model``) into a scope of its
own and runs it through ``Executor.run``, which runs the program through
the default pass pipeline and interprets it op by op on the device the
config picks: the GPU unless ``disable_gpu()`` was called (then the
CPU). ``clone()`` shares the scope and the program (clone-per-thread
serving) with an executor of its own. The IR switches
(``switch_ir_optim`` and the like) are kept for API parity: the pass
pipeline is ``FLAGS_program_passes``. Batched, CUDA-graph-captured
serving of the same saved model is ``serving.InferenceServer``.

``export_stablehlo`` (an XLA artifact) has no counterpart in the port
and raises ``NotImplementedError``.
"""
import os

import numpy as np


class AnalysisConfig:
    """Where the model is and where it runs (the reference's
    ``paddle_analysis_config.h`` API)."""

    def __init__(self, model_dir=None, prog_file=None, params_file=None):
        self._model_dir = model_dir
        self._prog_file = prog_file
        self._params_file = params_file
        self._ir_optim = True
        self._use_feed_fetch_ops = False
        self._memory_optim = False
        self._cpu_math_threads = 1
        self._profile = False
        self._glog_info = True
        self._use_gpu = True
        self._device_id = 0

    # -- model paths -----------------------------------------------------
    def set_model(self, model_dir_or_prog, params_file=None):
        if params_file is None:
            self._model_dir = model_dir_or_prog
        else:
            self._prog_file = model_dir_or_prog
            self._params_file = params_file

    def model_dir(self):
        return self._model_dir

    def prog_file(self):
        return self._prog_file

    def params_file(self):
        return self._params_file

    # -- switches kept for API parity ------------------------------------
    def switch_ir_optim(self, x=True):
        self._ir_optim = bool(x)

    def ir_optim(self):
        return self._ir_optim

    def switch_use_feed_fetch_ops(self, x=True):
        self._use_feed_fetch_ops = bool(x)

    def enable_memory_optim(self):
        self._memory_optim = True

    def enable_profile(self):
        self._profile = True

    def disable_glog_info(self):
        self._glog_info = False

    def set_cpu_math_library_num_threads(self, n):
        self._cpu_math_threads = int(n)

    def cpu_math_library_num_threads(self):
        return self._cpu_math_threads

    # -- device ----------------------------------------------------------
    def enable_use_gpu(self, memory_pool_init_size_mb=100, device_id=0):
        """Run on GPU ``device_id`` (the default)."""
        self._use_gpu = True
        self._device_id = int(device_id)

    def disable_gpu(self):
        """Run on the CPU (the plain PyTorch versions of the kernels)."""
        self._use_gpu = False

    def use_gpu(self):
        return self._use_gpu

    def gpu_device_id(self):
        return self._device_id

    def place(self):
        from ..framework.core import CPUPlace, CUDAPlace
        return CUDAPlace(self._device_id) if self._use_gpu else CPUPlace()

    def enable_tensorrt_engine(self, *a, **k):
        raise NotImplementedError("paddle_tpu_torch: TensorRT engines are "
                                  "not part of the port")


class _IOTensor:
    """Zero-copy-style handle (the reference's ``ZeroCopyTensor``): an
    input keeps the host array the predictor feeds; an output holds the
    last run's fetched tensor."""

    def __init__(self, name):
        self.name = name
        self._value = None

    def copy_from_cpu(self, arr):
        self._value = np.ascontiguousarray(arr)

    def copy_to_cpu(self):
        from ..framework.executor import _to_numpy
        v = self._value
        return _to_numpy(v) if hasattr(v, "detach") else np.asarray(v)

    def shape(self):
        return list(np.shape(self._value))


class AnalysisPredictor:
    """Load once, run many; ``clone()`` shares the weights and the
    program (clone-per-thread)."""

    def __init__(self, config, _shared=None):
        from ..framework.executor import Executor, Scope
        self._config = config
        self._exe = Executor(config.place())
        if _shared is not None:
            (self._scope, self._program, self._feed_names,
             self._fetch_targets) = _shared
        else:
            from .. import io as fluid_io
            self._scope = Scope()
            model_dir = config.model_dir()
            model_filename = params_filename = None
            if model_dir is None:
                model_dir = os.path.dirname(config.prog_file())
                model_filename = os.path.basename(config.prog_file())
                params_filename = os.path.basename(config.params_file()) \
                    if config.params_file() else None
            (self._program, self._feed_names,
             self._fetch_targets) = fluid_io.load_inference_model(
                model_dir, self._exe, model_filename=model_filename,
                params_filename=params_filename, scope=self._scope)
        self._inputs = {n: _IOTensor(n) for n in self._feed_names}
        self._outputs = {t.name: _IOTensor(t.name)
                         for t in self._fetch_targets}

    # -- handles ---------------------------------------------------------
    def get_input_names(self):
        return list(self._feed_names)

    def get_output_names(self):
        return [t.name for t in self._fetch_targets]

    def get_input_handle(self, name):
        return self._inputs[name]

    get_input_tensor = get_input_handle

    def get_output_handle(self, name):
        return self._outputs[name]

    get_output_tensor = get_output_handle

    # -- execution -------------------------------------------------------
    def run(self, inputs=None):
        """With ``inputs`` (numpy arrays in feed order): returns the
        outputs as numpy arrays. Without: feeds from the input handles
        and fills the output handles. The scope is passed explicitly, so
        clones sharing weights can run in parallel threads."""
        if inputs is not None:
            for n, a in zip(self._feed_names, inputs):
                self._inputs[n].copy_from_cpu(a)
        feed = {n: self._inputs[n]._value for n in self._feed_names}
        for n, v in feed.items():
            if v is None:
                raise ValueError(f"input {n!r} was never set: call "
                                 f"get_input_handle({n!r}).copy_from_cpu()")
        outs = self._exe.run(self._program, feed=feed,
                             fetch_list=[t.name
                                         for t in self._fetch_targets],
                             scope=self._scope, return_numpy=False)
        for t, v in zip(self._fetch_targets, outs):
            self._outputs[t.name]._value = v
        if inputs is not None:
            return [self._outputs[t.name].copy_to_cpu()
                    for t in self._fetch_targets]
        return True

    def prepare(self, input_shapes, dtype_map=None):
        """Run one zero-filled batch per given signature, so the first
        real request finds the optimized program (and the kernels)
        built. ``input_shapes``: ``{feed_name: shape}`` or shapes in feed
        order."""
        if isinstance(input_shapes, (list, tuple)):
            input_shapes = dict(zip(self._feed_names, input_shapes))
        feeds = []
        for n in self._feed_names:
            var = self._program.global_block().vars.get(n)
            dt = (dtype_map or {}).get(
                n, getattr(var, "dtype", "float32") or "float32")
            feeds.append(np.zeros(input_shapes[n], dtype=np.dtype(dt)))
        self.run(feeds)
        return self

    def cache_stats(self):
        """Entries of this predictor's executor's optimized-program
        memo."""
        return {"entries": len(self._exe._opt_cache)}

    def clone(self):
        """Share weights and program; an executor of its own."""
        return AnalysisPredictor(
            self._config,
            _shared=(self._scope, self._program, self._feed_names,
                     self._fetch_targets))

    def program(self):
        return self._program


def create_paddle_predictor(config):
    """The reference's ``CreatePaddlePredictor<AnalysisConfig>``."""
    return AnalysisPredictor(config)


create_predictor = create_paddle_predictor


def export_stablehlo(*args, **kwargs):
    raise NotImplementedError(
        "paddle_tpu_torch: export_stablehlo writes an XLA artifact, which "
        "has no counterpart in the PyTorch port; serve the saved model "
        "with inference.AnalysisPredictor or serving.InferenceServer")


__all__ = ["AnalysisConfig", "AnalysisPredictor", "create_paddle_predictor",
           "create_predictor", "export_stablehlo"]
