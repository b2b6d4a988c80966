"""Generic thread-safe LRU cache, capped by entry count and/or total
byte cost.

A copy of ``paddle_tpu/utils/lru.py`` (stdlib only): the serving
``ExecutableCache`` builds its entry- and byte-capped cache of captured
CUDA graphs on it.
"""
import threading
from collections import OrderedDict


class LRUCache:
    """Thread-safe LRU keyed map, capped by entry count and/or total
    byte cost. ``max_entries``/``max_bytes`` of ``None`` (or 0) mean
    unbounded on that axis. Eviction never removes the entry being
    inserted — a single entry larger than ``max_bytes`` is kept
    (the server could not make progress otherwise) and everything else
    is evicted around it."""

    def __init__(self, max_entries=None, max_bytes=None, on_evict=None):
        self.max_entries = int(max_entries) if max_entries else None
        self.max_bytes = int(max_bytes) if max_bytes else None
        self._data = OrderedDict()          # key -> (value, nbytes)
        self._lock = threading.RLock()
        self._on_evict = on_evict
        self._bytes = 0
        self._hits = 0
        self._misses = 0
        self._evictions = 0
        self._inserts = 0

    # -- mapping surface --------------------------------------------------
    def get(self, key, default=None):
        with self._lock:
            ent = self._data.get(key)
            if ent is None:
                self._misses += 1
                return default
            self._data.move_to_end(key)
            self._hits += 1
            return ent[0]

    def put(self, key, value, nbytes=0):
        evicted = []
        with self._lock:
            old = self._data.pop(key, None)
            if old is not None:
                self._bytes -= old[1]
            nbytes = int(nbytes)
            self._data[key] = (value, nbytes)
            self._bytes += nbytes
            self._inserts += 1
            while len(self._data) > 1 and (
                    (self.max_entries and len(self._data) > self.max_entries)
                    or (self.max_bytes and self._bytes > self.max_bytes)):
                k, (v, b) = self._data.popitem(last=False)
                self._bytes -= b
                self._evictions += 1
                evicted.append((k, v))
        if self._on_evict is not None:
            for k, v in evicted:
                self._on_evict(k, v)
        return value

    def __setitem__(self, key, value):
        self.put(key, value)

    def pop(self, key, default=None):
        with self._lock:
            ent = self._data.pop(key, None)
            if ent is None:
                return default
            self._bytes -= ent[1]
            return ent[0]

    def __contains__(self, key):
        with self._lock:
            return key in self._data

    def __len__(self):
        with self._lock:
            return len(self._data)

    def keys(self):
        with self._lock:
            return list(self._data.keys())

    def values(self):
        with self._lock:
            return [v for v, _ in self._data.values()]

    def items(self):
        with self._lock:
            return [(k, v) for k, (v, _) in self._data.items()]

    def clear(self):
        with self._lock:
            self._data.clear()
            self._bytes = 0

    # -- observability ----------------------------------------------------
    @property
    def nbytes(self):
        with self._lock:
            return self._bytes

    def stats(self):
        with self._lock:
            return {
                "entries": len(self._data),
                "bytes": self._bytes,
                "max_entries": self.max_entries or 0,
                "max_bytes": self.max_bytes or 0,
                "hits": self._hits,
                "misses": self._misses,
                "evictions": self._evictions,
                "inserts": self._inserts,
            }
