"""Runtime flags of the PyTorch port: the subset of ``paddle_tpu.flags``
that the generation and serving path reads, with the same names, the
same defaults and the same ``FLAGS_<name>`` environment override (read
once, at import).

``flag(name)`` is the getter.
"""
import os

_DEFS = {
    # name: (default, type)
    # -- serving front end --
    # admission: hard pending-request cap (backpressure)
    "serving_queue_depth": (256, int),
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
}

_values = {}


def _coerce(raw, typ):
    if typ is bool:
        return str(raw).lower() in ("1", "true", "yes", "on")
    return typ(raw)


def flag(name):
    return _values[name]


for _name, (_default, _typ) in _DEFS.items():
    _raw = os.environ.get(f"FLAGS_{_name}")
    _values[_name] = _coerce(_raw, _typ) if _raw is not None else _default
