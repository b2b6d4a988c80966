"""dygraph.Layer, the imperative module system (a copy of
``paddle_tpu/dygraph/layers.py``). Parameters are eager VarBases on the
tracer's device, initialized at construction from numpy's ``default_rng``
stream (``eager_initialize``, ``set_init_seed``), the JAX package's
stream: a freshly built model of either package holds the same
parameters."""
import numpy as np
import torch

from ..framework import unique_name
from ..framework import initializer as I
from ..framework.dtype import convert_dtype
from ..param_attr import ParamAttr
from .base import VarBase

_init_rng = np.random.default_rng(0)


def set_init_seed(seed):
    global _init_rng
    _init_rng = np.random.default_rng(seed)


def np_dtype(dtype):
    """The numpy type an initial value is drawn in (float32 for bf16,
    which ``VarBase`` then casts)."""
    name = convert_dtype(dtype)
    return np.dtype(np.float32 if name == "bfloat16" else name)


def _fan_in_out(shape):
    if len(shape) == 0:
        return 1, 1
    if len(shape) == 1:
        return shape[0], shape[0]
    receptive = int(np.prod(shape[2:])) if len(shape) > 2 else 1
    return shape[1] * receptive, shape[0] * receptive


def eager_initialize(initializer, shape, dtype="float32"):
    """Evaluate an Initializer to a concrete array (imperative-mode twin of
    the startup-program ops the initializers emit in static mode)."""
    dt = np_dtype(convert_dtype(dtype))
    shape = tuple(int(s) for s in shape)
    rng = _init_rng
    if initializer is None:
        initializer = I.XavierInitializer()
    if isinstance(initializer, I.ConstantInitializer):
        return np.full(shape, initializer.value, dt)
    if isinstance(initializer, I.UniformInitializer):
        return rng.uniform(initializer.low, initializer.high,
                           shape).astype(dt)
    if isinstance(initializer, I.NormalInitializer):
        return (initializer.loc +
                initializer.scale * rng.standard_normal(shape)).astype(dt)
    if isinstance(initializer, I.TruncatedNormalInitializer):
        vals = rng.standard_normal(shape)
        bad = np.abs(vals) > 2
        while bad.any():
            vals[bad] = rng.standard_normal(int(bad.sum()))
            bad = np.abs(vals) > 2
        return (initializer.loc + initializer.scale * vals).astype(dt)
    if isinstance(initializer, I.XavierInitializer):
        fan_in, fan_out = _fan_in_out(shape)
        if getattr(initializer, "uniform", True):
            limit = np.sqrt(6.0 / (fan_in + fan_out))
            return rng.uniform(-limit, limit, shape).astype(dt)
        std = np.sqrt(2.0 / (fan_in + fan_out))
        return (std * rng.standard_normal(shape)).astype(dt)
    if isinstance(initializer, I.MSRAInitializer):
        fan_in, _ = _fan_in_out(shape)
        if getattr(initializer, "uniform", True):
            limit = np.sqrt(6.0 / fan_in)
            return rng.uniform(-limit, limit, shape).astype(dt)
        std = np.sqrt(2.0 / fan_in)
        return (std * rng.standard_normal(shape)).astype(dt)
    raise NotImplementedError(
        f"eager init for {type(initializer).__name__}")


def _like(value, ref):
    """``value`` (numpy, VarBase or tensor) as a new tensor of ``ref``'s
    type on its device."""
    if isinstance(value, VarBase):
        value = value.value
    if isinstance(value, torch.Tensor):
        return value.to(device=ref.device, dtype=ref.dtype, copy=True)
    return torch.from_numpy(np.array(value)).to(device=ref.device,
                                                dtype=ref.dtype)


class HookRemoveHelper:
    """Handle returned by register_forward_*_hook; .remove() detaches."""

    def __init__(self, store, hid):
        self._store = store
        self._hid = hid

    def remove(self):
        self._store.pop(self._hid, None)


class Layer:
    """Module base: owns parameters + sublayers, tracks train/eval mode."""

    def __init__(self, name_scope=None, dtype="float32"):
        self._full_name = unique_name.generate(
            name_scope or type(self).__name__.lower())
        self._dtype = dtype
        self._parameters = {}
        self._buffers = {}       # non-trainable state (BN running stats)
        self._sub_layers = {}
        self._forward_pre_hooks = {}
        self._forward_post_hooks = {}
        self._hook_counter = 0
        self.training = True

    def full_name(self):
        return self._full_name

    # ---- parameter management ----
    def create_parameter(self, shape, attr=None, dtype=None, is_bias=False,
                         default_initializer=None):
        attr = ParamAttr._to_attr(attr)
        if attr is False:
            return None
        dtype = dtype or self._dtype
        init = attr.initializer or default_initializer
        if init is None:
            init = (I.ConstantInitializer(0.0) if is_bias
                    else I.XavierInitializer())
        value = eager_initialize(init, shape, dtype)
        name = attr.name or unique_name.generate(
            f"{self._full_name}.b" if is_bias else f"{self._full_name}.w")
        p = VarBase(value, name=name, stop_gradient=not attr.trainable,
                    persistable=True, dtype=dtype)
        p.trainable = attr.trainable
        p.optimize_attr = {"learning_rate": attr.learning_rate}
        p.regularizer = attr.regularizer
        p.is_parameter = True
        return p

    def add_parameter(self, name, parameter):
        self._parameters[name] = parameter
        return parameter

    def register_buffer(self, name, buffer):
        """Non-trainable state saved in state_dict (BN running stats etc.)."""
        self._buffers[name] = buffer
        object.__setattr__(self, name, buffer)
        return buffer

    def add_sublayer(self, name, sublayer):
        self._sub_layers[name] = sublayer
        return sublayer

    def __setattr__(self, name, value):
        params = self.__dict__.get("_parameters")
        subs = self.__dict__.get("_sub_layers")
        if params is not None and isinstance(value, VarBase) and \
                getattr(value, "is_parameter", False):
            params[name] = value
        elif subs is not None and isinstance(value, Layer):
            subs[name] = value
        object.__setattr__(self, name, value)

    def parameters(self, include_sublayers=True):
        return [p for _, p in self.named_parameters(include_sublayers)]

    def named_parameters(self, include_sublayers=True, prefix=""):
        out = []
        for n, p in self._parameters.items():
            if p is not None:
                out.append((f"{prefix}{n}" if prefix else n, p))
        if include_sublayers:
            for sn, sub in self._sub_layers.items():
                out.extend(sub.named_parameters(
                    True, prefix=f"{prefix}{sn}." if prefix else f"{sn}."))
        return out

    def sublayers(self, include_sublayers=True):
        out = list(self._sub_layers.values())
        if include_sublayers:
            for s in list(out):
                out.extend(s.sublayers(True))
        return out

    # ---- mode ----
    def train(self):
        self.training = True
        for s in self.sublayers():
            s.training = True
        return self

    def eval(self):
        self.training = False
        for s in self.sublayers():
            s.training = False
        return self

    # ---- state dict ----
    def state_dict(self, include_sublayers=True, prefix=""):
        """Params + buffers, recursing through sublayers' own state_dict so
        overrides and buffers are honored."""
        out = {}
        for n, p in self._parameters.items():
            if p is not None:
                out[prefix + n] = p.numpy()
        for n, b in self._buffers.items():
            out[prefix + n] = b.numpy()
        if include_sublayers:
            for sn, sub in self._sub_layers.items():
                out.update(sub.state_dict(True, prefix=f"{prefix}{sn}."))
        return out

    def set_dict(self, state, include_sublayers=True,
                 use_structured_name=True, prefix=""):
        for n, p in self._parameters.items():
            if p is not None and prefix + n in state:
                p.value = _like(state[prefix + n], p.value)
        for n, b in self._buffers.items():
            if prefix + n in state:
                b.value = _like(state[prefix + n], b.value)
        if include_sublayers:
            for sn, sub in self._sub_layers.items():
                sub.set_dict(state, True, use_structured_name,
                             prefix=f"{prefix}{sn}.")
    load_dict = set_dict
    set_state_dict = set_dict

    def clear_gradients(self):
        for p in self.parameters():
            p.clear_gradient()

    # ---- forward hooks (reference dygraph/layers.py:60
    # register_forward_pre_hook / register_forward_post_hook) ----
    def register_forward_pre_hook(self, hook):
        """hook(layer, inputs) -> None | new inputs (tuple or single)."""
        return self._register_hook(self._forward_pre_hooks, hook)

    def register_forward_post_hook(self, hook):
        """hook(layer, inputs, output) -> None | new output."""
        return self._register_hook(self._forward_post_hooks, hook)

    def _register_hook(self, store, hook):
        hid = self._hook_counter
        self._hook_counter += 1
        store[hid] = hook
        return HookRemoveHelper(store, hid)

    def __call__(self, *args, **kwargs):
        for hook in self._forward_pre_hooks.values():
            res = hook(self, args)
            if res is not None:
                args = res if isinstance(res, tuple) else (res,)
        out = self.forward(*args, **kwargs)
        for hook in self._forward_post_hooks.values():
            res = hook(self, args, out)
            if res is not None:
                out = res
        return out

    def forward(self, *args, **kwargs):
        raise NotImplementedError
