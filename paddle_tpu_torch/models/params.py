"""Parameters from a JAX scope for a model of the port."""
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
