"""Bounded cache of captured programs for the serving runtime.

Counterpart of ``paddle_tpu/serving/cache.py``. The JAX package caches
compiled XLA executables keyed on a feed signature; the port caches
:class:`~paddle_tpu_torch.framework.cuda_graph.CapturedProgram` entries
(a CUDA graph each on the GPU), capped by entry count and by bytes (each
entry costs the graph memory pool's growth at its capture), with
hit/miss/evict counters in ``server.stats()`` and each eviction in the
flight recorder (an ``eviction`` event). ``record`` and
``load_signatures`` write and read the observed signatures, so a
restarted server can capture yesterday's traffic before taking more.
"""
import json
import os
import warnings

from ..utils.lru import LRUCache


def feed_signature(feed):
    """Canonical cache key of a feed dict: sorted ``(name, shape,
    dtype)`` triples (numpy arrays or anything with ``.shape`` and
    ``.dtype``)."""
    return tuple(sorted(
        (name, tuple(int(d) for d in arr.shape), str(arr.dtype))
        for name, arr in feed.items()))


class ExecutableCache(LRUCache):
    """LRU of captured programs keyed by feed signature. Caps default to
    ``FLAGS_serving_cache_entries`` / ``FLAGS_serving_cache_bytes``
    (0 = unbounded)."""

    def __init__(self, max_entries=None, max_bytes=None, on_evict=None):
        from ..flags import flag
        if max_entries is None:
            max_entries = flag("serving_cache_entries")
        if max_bytes is None:
            max_bytes = flag("serving_cache_bytes")

        def _evict_hook(key, value, _user=on_evict):
            # every eviction lands in the flight recorder: "why did that
            # signature capture again" is answerable
            from ..observability.recorder import flight_recorder
            flight_recorder().record("eviction", cache="executable",
                                     signature=str(key)[:200])
            if _user is not None:
                _user(key, value)

        super().__init__(max_entries=max_entries, max_bytes=max_bytes,
                         on_evict=_evict_hook)

    signature = staticmethod(feed_signature)

    def record(self, path):
        """Write the cached signatures (most recently used last) to a
        JSON file (temp write, fsync, atomic rename); returns how many."""
        doc = [[[name, list(shape), dtype] for name, shape, dtype in sig]
               for sig in self.keys()]
        tmp = path + ".tmp"
        with open(tmp, "w") as f:
            json.dump({"version": 1, "signatures": doc}, f)
            f.flush()
            os.fsync(f.fileno())
        os.replace(tmp, path)
        return len(doc)

    @staticmethod
    def load_signatures(path):
        """A signature file as a list of ``{name: (shape, dtype)}``. A
        missing or unreadable file gives [] with a warning: recorded
        traffic is a hint, it never stops a server from starting."""
        try:
            with open(path) as f:
                doc = json.load(f)
            return [{name: (tuple(shape), dtype)
                     for name, shape, dtype in sig}
                    for sig in doc.get("signatures", [])]
        except (OSError, ValueError, TypeError) as e:
            warnings.warn(f"serving signature file {path!r} unreadable "
                          f"({e}); warming up without it", stacklevel=2)
            return []
