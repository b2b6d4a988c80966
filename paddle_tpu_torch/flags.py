"""Runtime flags of the PyTorch port: the subset of ``paddle_tpu.flags``
that the ported paths read, with the same names, the same defaults and
the same ``FLAGS_<name>`` environment override (read once, at import).

``flag(name)`` is the getter; ``get_flags``/``set_flags`` are the
``fluid`` ones (names with or without the ``FLAGS_`` prefix).
"""
import os

_DEFS = {
    # name: (default, type)
    # -- serving front end --
    # admission: hard pending-request cap (backpressure)
    "serving_queue_depth": (256, int),
    # -- training loop --
    # scan fetched outputs and updated state for nan/inf after each step
    # and raise NonFiniteError (Executor.run / run_steps default)
    "check_nan_inf": (False, bool),
    # train_from_dataset: steps per run_steps slab (1 = one run a step)
    "steps_per_run": (1, int),
    # train_from_dataset's fused path: fetch on every N-th slab only
    # (and on print_period slabs and the last)
    "fetch_every_n": (1, int),
    # micro-batching: a group flushes at this many rows, or when its
    # oldest request has waited batch_timeout_ms
    "serving_max_batch_size": (32, int),
    "serving_batch_timeout_ms": (5.0, float),
    # captured-program cache caps (0 bytes = unbounded)
    "serving_cache_entries": (32, int),
    "serving_cache_bytes": (0, int),
    # -- KV-cached generation --
    # per-layer KV cache length: prompt + max_new_tokens must fit
    # (clamped to the model's max_position)
    "decode_max_len": (2048, int),
    # minimum prefill sequence bucket (power-of-two buckets above it)
    "decode_bucket_min": (16, int),
    # serving decode bank: generation slots stepped together
    "decode_slots": (8, int),
    # -- paged KV cache --
    # block-paged decode memory instead of the dense [slots, H, L, D] bank
    "kv_paged": (False, bool),
    # pool element type: fp32, bf16, or int8 with per-(block, head, slot)
    # float32 scales
    "kv_cache_dtype": ("fp32", str),
    "kv_block_size": (16, int),
    # total pool blocks incl. the trash block; 0 = dense-bank equivalent
    # (slots * ceil(max_len / block_size) + 1)
    "kv_pool_blocks": (0, int),
    # cuDNN convolutions (forward, dgrad, wgrad) take deterministic
    # algorithms only: a training step is the same bits run to run, and
    # a replayed step the bits of its eager run (the JAX package accepts
    # it and leaves the algorithms to XLA)
    "cudnn_deterministic": (False, bool),
    # -- program passes --
    # the executor's pre-lowering pipeline over a clone of the program:
    # "1" = dce,cse,fuse_optimizer; "0" = off (the program runs as
    # built); or a comma-separated pass list, run in canonical order
    "program_passes": ("1", str),
    # program verification: each executor memo miss verifies the user
    # program and every pass's output (framework/analysis.py)
    "verify_passes": (False, bool),
    # byte cap of one fused-optimizer bucket, in megabytes of parameters
    "fuse_optimizer_bucket_mb": (64, int),
}

_values = {}


def _coerce(raw, typ):
    if typ is bool:
        return str(raw).lower() in ("1", "true", "yes", "on")
    return typ(raw)


def flag(name):
    return _values[name]


def _key(name):
    key = name[6:] if name.startswith("FLAGS_") else name
    if key not in _DEFS:
        raise ValueError(f"unknown flag {name!r}")
    return key


def get_flags(flags):
    """``{name: value}`` for one name or a list of names."""
    names = [flags] if isinstance(flags, str) else list(flags)
    return {n: _values[_key(n)] for n in names}


def set_flags(flags_dict):
    for n, v in flags_dict.items():
        key = _key(n)
        _values[key] = _coerce(v, _DEFS[key][1])


for _name, (_default, _typ) in _DEFS.items():
    _raw = os.environ.get(f"FLAGS_{_name}")
    _values[_name] = _coerce(_raw, _typ) if _raw is not None else _default
