"""dygraph.nn layer classes (a trimmed copy of
``paddle_tpu/dygraph/nn.py``): ``Linear``/``FC`` (the ``mul`` op),
``Conv2D``, ``Pool2D``, ``BatchNorm``, ``Embedding``
(``lookup_table_v2``), ``LayerNorm`` and ``Dropout``. Each forward runs
the registered op lowerings through the eager tracer; outputs start as
placeholders that hold no tensor. The other classes of the JAX module
(``LSTMCell`` ... ``TreeConv``) raise ``NotImplementedError``."""
import numpy as np

from ..framework import initializer as I
from .base import VarBase, _current_tracer, not_ported
from .layers import Layer, np_dtype


def _trace(op_type, inputs, n_out=1, attrs=None, out_dtype="float32",
           extra_outputs=None, out_slot="Out"):
    tracer = _current_tracer()
    outs = {out_slot: [VarBase(stop_gradient=False, dtype=out_dtype)
                       for _ in range(n_out)]}
    for slot, vars_ in (extra_outputs or {}).items():
        outs[slot] = vars_
    tracer.trace_op(op_type, inputs, outs, attrs or {})
    res = outs[out_slot]
    return res[0] if n_out == 1 else res


class Linear(Layer):
    def __init__(self, input_dim, output_dim, param_attr=None,
                 bias_attr=None, act=None, dtype="float32"):
        super().__init__(dtype=dtype)
        self.weight = self.create_parameter([input_dim, output_dim],
                                            attr=param_attr, dtype=dtype)
        self.bias = self.create_parameter([output_dim], attr=bias_attr,
                                          dtype=dtype, is_bias=True)
        self._act = act

    def forward(self, x):
        out = _trace("mul", {"X": [x], "Y": [self.weight]},
                     attrs={"x_num_col_dims": x.ndim - 1,
                            "y_num_col_dims": 1}, out_dtype=self._dtype)
        if self.bias is not None:
            out = _trace("elementwise_add",
                         {"X": [out], "Y": [self.bias]},
                         attrs={"axis": x.ndim - 1}, out_dtype=self._dtype)
        if self._act:
            out = _trace(self._act, {"X": [out]}, out_dtype=self._dtype)
        return out


FC = Linear


class Conv2D(Layer):
    def __init__(self, num_channels, num_filters, filter_size, stride=1,
                 padding=0, dilation=1, groups=1, param_attr=None,
                 bias_attr=None, use_cudnn=True, act=None, dtype="float32"):
        super().__init__(dtype=dtype)
        fs = filter_size if isinstance(filter_size, (list, tuple)) \
            else (filter_size, filter_size)
        self._attrs = {
            "strides": list(stride if isinstance(stride, (list, tuple))
                            else (stride, stride)),
            "paddings": list(padding if isinstance(padding, (list, tuple))
                             else (padding, padding)),
            "dilations": list(dilation if isinstance(dilation,
                                                     (list, tuple))
                              else (dilation, dilation)),
            "groups": groups, "data_format": "NCHW"}
        std = (2.0 / (num_channels * fs[0] * fs[1])) ** 0.5
        self.weight = self.create_parameter(
            [num_filters, num_channels // groups, fs[0], fs[1]],
            attr=param_attr, dtype=dtype,
            default_initializer=I.NormalInitializer(0.0, std))
        self.bias = self.create_parameter([num_filters], attr=bias_attr,
                                          dtype=dtype, is_bias=True)
        self._act = act

    def forward(self, x):
        out = _trace("conv2d", {"Input": [x], "Filter": [self.weight]},
                     attrs=self._attrs, out_dtype=self._dtype,
                     out_slot="Output")
        if self.bias is not None:
            out = _trace("elementwise_add", {"X": [out], "Y": [self.bias]},
                         attrs={"axis": 1}, out_dtype=self._dtype)
        if self._act:
            out = _trace(self._act, {"X": [out]}, out_dtype=self._dtype)
        return out


class Pool2D(Layer):
    def __init__(self, pool_size=-1, pool_type="max", pool_stride=1,
                 pool_padding=0, global_pooling=False, use_cudnn=True,
                 ceil_mode=False, exclusive=True, dtype="float32"):
        super().__init__(dtype=dtype)
        p = pool_size if isinstance(pool_size, (list, tuple)) \
            else (pool_size, pool_size)
        s = pool_stride if isinstance(pool_stride, (list, tuple)) \
            else (pool_stride, pool_stride)
        pad = pool_padding if isinstance(pool_padding, (list, tuple)) \
            else (pool_padding, pool_padding)
        self._attrs = {"pooling_type": pool_type, "ksize": list(p),
                       "strides": list(s), "paddings": list(pad),
                       "global_pooling": global_pooling,
                       "ceil_mode": ceil_mode, "exclusive": exclusive,
                       "adaptive": False}

    def forward(self, x):
        return _trace("pool2d", {"X": [x]}, attrs=self._attrs,
                      out_dtype=self._dtype)


class BatchNorm(Layer):
    def __init__(self, num_channels, act=None, is_test=False, momentum=0.9,
                 epsilon=1e-5, param_attr=None, bias_attr=None,
                 dtype="float32", data_layout="NCHW",
                 use_global_stats=False, trainable_statistics=False):
        super().__init__(dtype=dtype)
        self.weight = self.create_parameter(
            [num_channels], attr=param_attr, dtype=dtype,
            default_initializer=I.ConstantInitializer(1.0))
        self.bias = self.create_parameter([num_channels], attr=bias_attr,
                                          dtype=dtype, is_bias=True)
        self.register_buffer("_mean", VarBase(
            np.zeros(num_channels, np_dtype(dtype)),
            stop_gradient=True, persistable=True, dtype=dtype))
        self.register_buffer("_variance", VarBase(
            np.ones(num_channels, np_dtype(dtype)),
            stop_gradient=True, persistable=True, dtype=dtype))
        self._momentum = momentum
        self._epsilon = epsilon
        self._layout = data_layout
        self._use_global_stats = use_global_stats
        self._act = act

    def forward(self, x):
        tracer = _current_tracer()
        dt = self._dtype
        y = VarBase(stop_gradient=False, dtype=dt)
        mean_out = VarBase(stop_gradient=True, dtype=dt)
        var_out = VarBase(stop_gradient=True, dtype=dt)
        saved_m = VarBase(stop_gradient=True, dtype=dt)
        saved_v = VarBase(stop_gradient=True, dtype=dt)
        tracer.trace_op(
            "batch_norm",
            {"X": [x], "Scale": [self.weight], "Bias": [self.bias],
             "Mean": [self._mean], "Variance": [self._variance]},
            {"Y": [y], "MeanOut": [mean_out], "VarianceOut": [var_out],
             "SavedMean": [saved_m], "SavedVariance": [saved_v]},
            {"momentum": self._momentum, "epsilon": self._epsilon,
             "is_test": not self.training,
             "use_global_stats": self._use_global_stats,
             "data_layout": self._layout})
        # fold running-stat updates back (reference does this in-place)
        self._mean.value = mean_out.value
        self._variance.value = var_out.value
        if self._act:
            y = _trace(self._act, {"X": [y]}, out_dtype=self._dtype)
        return y


class Embedding(Layer):
    def __init__(self, size, is_sparse=False, is_distributed=False,
                 padding_idx=None, param_attr=None, dtype="float32"):
        super().__init__(dtype=dtype)
        self.weight = self.create_parameter(
            list(size), attr=param_attr, dtype=dtype,
            default_initializer=I.XavierInitializer())
        self._padding_idx = -1 if padding_idx is None else padding_idx

    def forward(self, ids):
        return _trace("lookup_table_v2",
                      {"W": [self.weight], "Ids": [ids]},
                      attrs={"padding_idx": self._padding_idx},
                      out_dtype=self._dtype)


class LayerNorm(Layer):
    def __init__(self, normalized_shape, scale=True, shift=True,
                 epsilon=1e-5, param_attr=None, bias_attr=None, act=None,
                 dtype="float32"):
        super().__init__(dtype=dtype)
        if isinstance(normalized_shape, int):
            normalized_shape = [normalized_shape]
        n = int(np.prod(normalized_shape))
        self.weight = self.create_parameter(
            [n], attr=param_attr, dtype=dtype,
            default_initializer=I.ConstantInitializer(1.0)) if scale \
            else None
        self.bias = self.create_parameter([n], attr=bias_attr, dtype=dtype,
                                          is_bias=True) if shift else None
        self._epsilon = epsilon
        self._rank = len(normalized_shape)
        self._act = act

    def forward(self, x):
        tracer = _current_tracer()
        dt = self._dtype
        y = VarBase(stop_gradient=False, dtype=dt)
        mean = VarBase(stop_gradient=True, dtype=dt)
        var = VarBase(stop_gradient=True, dtype=dt)
        ins = {"X": [x]}
        if self.weight is not None:
            ins["Scale"] = [self.weight]
        if self.bias is not None:
            ins["Bias"] = [self.bias]
        tracer.trace_op("layer_norm", ins,
                        {"Y": [y], "Mean": [mean], "Variance": [var]},
                        {"begin_norm_axis": x.ndim - self._rank,
                         "epsilon": self._epsilon})
        if self._act:
            y = _trace(self._act, {"X": [y]}, out_dtype=self._dtype)
        return y


class Dropout(Layer):
    def __init__(self, p=0.5, seed=None,
                 dropout_implementation="downgrade_in_infer",
                 is_test=False):
        super().__init__()
        self._p = p
        self._impl = dropout_implementation
        self._seed = seed

    def forward(self, x):
        from .. import layers
        return layers.dropout(x, self._p, is_test=not self.training,
                              seed=self._seed,
                              dropout_implementation=self._impl)


LSTMCell = not_ported("LSTMCell", "op not registered")
GRUCell = not_ported("GRUCell", "op not registered")
Conv2DTranspose = not_ported("Conv2DTranspose", "op not registered")
GroupNorm = not_ported("GroupNorm", "op not registered")
PRelu = not_ported("PRelu", "op not registered")
SpectralNorm = not_ported("SpectralNorm", "op not registered")
Conv3D = not_ported("Conv3D", "op not registered")
Conv3DTranspose = not_ported("Conv3DTranspose", "op not registered")
InstanceNorm = not_ported("InstanceNorm", "op not registered")
BilinearTensorProduct = not_ported("BilinearTensorProduct",
                                   "op not registered")
GRUUnit = not_ported("GRUUnit", "op not registered")
NCE = not_ported("NCE", "op not registered")
TreeConv = not_ported("TreeConv", "op not registered")
