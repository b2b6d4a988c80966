"""save_dygraph / load_dygraph (a copy of
``paddle_tpu/dygraph/checkpoint.py``). Format: one ``.npz`` per state
dict (``.pdparams`` for layer params, ``.pdopt`` for optimizer state),
the JAX package's, so either package loads what the other saved."""
import os

import numpy as np


OPT_STATE_KEY = "__optimizer_state__"


def save_dygraph(state_dict, model_path):
    """state_dict: Layer.state_dict() (saved as .pdparams) or an optimizer
    state dict carrying the OPT_STATE_KEY marker (saved as .pdopt)."""
    arrays = {}
    is_opt = state_dict.get(OPT_STATE_KEY, False) is not False and \
        OPT_STATE_KEY in state_dict
    for k, v in state_dict.items():
        if k == OPT_STATE_KEY:
            continue
        from .base import VarBase
        if isinstance(v, VarBase):
            v = v.numpy()
        arrays[k] = np.asarray(v)
    suffix = ".pdopt" if is_opt else ".pdparams"
    path = model_path + suffix
    os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
    np.savez(path, **arrays)
    # np.savez appends .npz; rename to the fluid-style suffix
    if os.path.exists(path + ".npz"):
        os.replace(path + ".npz", path)


def load_dygraph(model_path):
    """Returns (param_dict, opt_dict); either may be None."""
    def _load(path):
        if not os.path.exists(path):
            return None
        with np.load(path, allow_pickle=False) as z:
            return {k: z[k] for k in z.files}
    params = _load(model_path + ".pdparams")
    opt = _load(model_path + ".pdopt")
    if params is None and opt is None:
        raise ValueError(f"no checkpoint at {model_path}(.pdparams/.pdopt)")
    return params, opt
