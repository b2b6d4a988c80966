"""Parameters from the JAX package for a model of the port: from a JAX
scope (``pick_params``) or a JAX dygraph ``Layer.state_dict()``
(``layer_params_from_jax``)."""
import numpy as np
import torch


def pick_params(arrays, want, model):
    """``{name: float32 CPU tensor}`` for the names of ``want`` (``{name:
    shape}``) out of ``arrays`` (``{JAX scope name: array}``; other scope
    state, such as the optimizer's, is left out); raises on a missing or
    mis-shaped name, naming ``model``."""
    missing = sorted(set(want) - set(arrays))
    if missing:
        raise ValueError(f"{model} parameters are missing: {missing}")
    out = {}
    for name, shape in want.items():
        a = arrays[name]
        t = a.detach().to(torch.float32, copy=True) \
            if isinstance(a, torch.Tensor) \
            else torch.from_numpy(np.array(a, dtype=np.float32))
        if tuple(t.shape) != shape:
            raise ValueError(f"{model} parameter {name!r} has shape "
                             f"{tuple(t.shape)}, expected {shape}")
        out[name] = t
    return out


def _state_vars(layer, prefix=""):
    """{structured name: VarBase} of a dygraph Layer's parameters and
    buffers, as ``Layer.state_dict`` names them."""
    out = {prefix + n: p for n, p in layer._parameters.items()
           if p is not None}
    out.update({prefix + n: b for n, b in layer._buffers.items()})
    for sn, sub in layer._sub_layers.items():
        out.update(_state_vars(sub, f"{prefix}{sn}."))
    return out


def layer_params_from_jax(layer, state):
    """Load a JAX dygraph ``Layer.state_dict()`` (``{structured name:
    numpy array}``) into the port's dygraph ``layer`` of the same model;
    raises on a missing or mis-shaped name. Optimizer state is not
    carried: its keys hold ``unique_name`` counters."""
    own = _state_vars(layer)
    missing = sorted(set(own) - set(state))
    if missing:
        raise ValueError(f"{type(layer).__name__} state is missing: "
                         f"{missing}")
    for name, v in own.items():
        if tuple(np.shape(state[name])) != v.shape:
            raise ValueError(f"{name!r} has shape {np.shape(state[name])}, "
                             f"the layer holds {v.shape}")
    layer.set_dict({name: np.asarray(state[name]) for name in own})
    return layer
