"""Block-paged KV-cache pool: decode memory priced by the tokens a slot
actually holds.

Counterpart of ``paddle_tpu/serving/kvpool.py`` (``KVBlockPool``): a
LIFO free-list of fixed-size blocks shared by every slot, a per-slot
block table, blocks allocated on append and returned when a row
finishes. Block 0 is the reserved TRASH block: table entries past a
row's allocation name it, so padded prefill scatters and free slots
write garbage somewhere position masks never read. Exhaustion raises the
typed :class:`KVPoolExhaustedError` (a ``ServerOverloadedError``: the
client backs off).

Blocks are refcounted, which gives two more services:

- the block-granular prefix cache: a finished prompt's blocks go into a
  hash-keyed index (:meth:`KVBlockPool.prefix_insert`, keyed by
  :func:`prompt_prefix_key` at the exact and the block-aligned length);
  a later prompt sharing the prefix adopts them by reference
  (:meth:`~KVBlockPool.match_prefix`, :meth:`~KVBlockPool.adopt_prefix`)
  and prefills only its tail. Any write into a block with more than one
  owner is preceded by a copy-on-write (:meth:`~KVBlockPool.prepare_write`).
  Entries only the cache holds are evictable and go LRU under pressure;
- migration: :meth:`~KVBlockPool.export_slot` serializes a slot's blocks
  into a wire-safe payload (``KV_WIRE_FMT``; bf16 as its ``uint16`` bit
  pattern, int8 with its float32 scales) and :meth:`~KVBlockPool.import_slot`
  writes one into another pool: the two halves of disaggregated prefill
  and decode. Payloads are the JAX package's, field for field.

The device side is one ``[num_blocks, H, block_size, D]`` tensor per
layer for K and for V (float32, bfloat16, or int8 with float32 scales
``[num_blocks, H, block_size]``), allocated once and written in place by
the decode, chunk and verify steps, :meth:`~KVBlockPool.scatter_prefill`,
:meth:`~KVBlockPool.import_slot` and the copy-on-write: a captured decode
graph holds their addresses. :meth:`~KVBlockPool.drop_device` and
:meth:`~KVBlockPool.reset` release them, and every graph over them is
then captured anew (``framework.cuda_graph.CapturedDecode``).

Telemetry: the ``kvpool_*`` registry families (occupancy, capacity and
blocks-in-use gauges, allocator and prefix-cache counters, labeled by
the pool's ``name``) and the ``kv_pool_exhausted``, ``kv_block_leak`` and
``kv_prefix_evicted`` flight-recorder events, as the JAX package reports
them.
"""
import hashlib
import threading
from collections import OrderedDict

import numpy as np
import torch

from ..device import resolve_device
from ..flags import flag
from ..kernels.paged_attention import quantize_kv
from ..observability.metrics import default_registry
from ..observability.recorder import flight_recorder as _flightrec
from .batching import BadRequestError, ServerOverloadedError

_DTYPES = {"fp32": torch.float32, "bf16": torch.bfloat16,
           "int8": torch.int8}
_ELEM_BYTES = {"fp32": 4, "bf16": 2, "int8": 1}
# the element type of a payload's block arrays (bf16 travels as its
# uint16 bit pattern: numpy has no bfloat16 the wire accepts)
_WIRE_NP = {"fp32": np.float32, "bf16": np.uint16, "int8": np.int8}

# migration payload format tag (bumped on any layout change: an importer
# never guesses at a payload written by another revision)
KV_WIRE_FMT = "kvblocks1"

# -- metrics (native families; ``pool`` label keeps a serving pool and
#    transient offline pools from clobbering each other's gauges) --------

_BLOCKS_IN_USE = default_registry().gauge(
    "kvpool_blocks_in_use_count",
    "KV-pool blocks currently allocated to live slots",
    labels=("pool",), max_series=64)
_CAPACITY = default_registry().gauge(
    "kvpool_capacity_blocks_count",
    "KV-pool allocatable block capacity (trash block excluded)",
    labels=("pool",), max_series=64)
_OCCUPANCY = default_registry().gauge(
    "kvpool_occupancy_ratio",
    "allocated / allocatable KV-pool blocks",
    labels=("pool",), max_series=64)
_SAVED = default_registry().gauge(
    "kvpool_saved_vs_dense_bytes",
    "device bytes a dense [slots, H, max_len, D] fp32 bank would hold "
    "minus the pool bytes actually allocated",
    labels=("pool",), max_series=64)
_ALLOC_FAIL = default_registry().counter(
    "kvpool_alloc_failures_total",
    "block allocations refused with KVPoolExhaustedError",
    labels=("pool",), max_series=64)
_ALLOCATED = default_registry().counter(
    "kvpool_blocks_allocated_total",
    "KV-pool blocks handed out by the free-list allocator",
    labels=("pool",), max_series=64)
_FREED = default_registry().counter(
    "kvpool_blocks_freed_total",
    "KV-pool blocks returned to the free list",
    labels=("pool",), max_series=64)
_LEAKED = default_registry().counter(
    "kvpool_leaked_blocks_total",
    "blocks found still held by finished slots and reclaimed by the "
    "leak sweep",
    labels=("pool",), max_series=64)
_EXPORTED = default_registry().counter(
    "kvpool_blocks_exported_total",
    "KV blocks serialized out of the pool for cross-replica migration",
    labels=("pool",), max_series=64)
_IMPORTED = default_registry().counter(
    "kvpool_blocks_imported_total",
    "migrated KV blocks deserialized into the pool",
    labels=("pool",), max_series=64)
_PREFIX_ENTRIES = default_registry().gauge(
    "kvpool_prefix_entries_count",
    "prompt-prefix cache entries currently indexed",
    labels=("pool",), max_series=64)
_PREFIX_BLOCKS = default_registry().gauge(
    "kvpool_prefix_cached_blocks_count",
    "KV blocks held ONLY by the prefix cache (evictable under "
    "pressure; not counted as slot load)",
    labels=("pool",), max_series=64)
_PREFIX_HITS = default_registry().counter(
    "kvpool_prefix_hits_total",
    "prompt admissions that adopted cached prefix blocks",
    labels=("pool",), max_series=64)
_PREFIX_MISSES = default_registry().counter(
    "kvpool_prefix_misses_total",
    "prompt admissions that found no cached prefix",
    labels=("pool",), max_series=64)
_PREFIX_TOKENS_REUSED = default_registry().counter(
    "kvpool_prefix_tokens_reused_total",
    "prompt tokens whose prefill was skipped by adopting cached "
    "prefix blocks",
    labels=("pool",), max_series=64)
_PREFIX_EVICTIONS = default_registry().counter(
    "kvpool_prefix_evictions_total",
    "prefix-cache entries evicted LRU under pool pressure",
    labels=("pool",), max_series=64)
_PREFIX_COW = default_registry().counter(
    "kvpool_prefix_cow_copies_total",
    "shared KV blocks copy-on-write duplicated before a divergent "
    "write",
    labels=("pool",), max_series=64)

# per-pool event counters, reported by stats()
_COUNTERS = ("prefix_hits", "prefix_misses", "prefix_tokens_reused",
             "prefix_evictions", "prefix_cow_copies", "leaked_blocks",
             "blocks_exported", "blocks_imported", "alloc_failures")


class PoolView:
    """A :class:`KVBlockPool` fixed at one moment: :meth:`layers`,
    :meth:`tensors`, ``tables`` and :meth:`device_tables` read the device
    arrays and a copy of the block tables taken then; anything else is
    the pool's. A serving step runs over one, so a step that a watchdog
    abandoned and that wakes up after the pool was released and built
    anew still writes the released arrays, never the new ones."""

    def __init__(self, pool):
        self._pool = pool
        self._layers = pool.layers()
        self.tables = pool.tables.copy()

    def __getattr__(self, name):
        return getattr(self._pool, name)

    def layers(self):
        return self._layers

    def tensors(self):
        return [t for layer in self._layers for t in layer
                if t is not None]

    def device_tables(self, rows=None):
        t = self.tables if rows is None else self.tables[list(rows)]
        return torch.from_numpy(np.ascontiguousarray(t)).to(self.device)


def pool_feed_names(num_layers, quantized):
    """Feed and fetch names of the paged programs' pool tensors
    (``models.gpt.gpt_decode_step_paged`` and its siblings), in the one
    order the JAX package uses: the k pools, the v pools, then (int8
    only) the k and v scale pools."""
    names = [f"cache_pk_{i}" for i in range(num_layers)] \
        + [f"cache_pv_{i}" for i in range(num_layers)]
    if quantized:
        names += [f"cache_pks_{i}" for i in range(num_layers)] \
            + [f"cache_pvs_{i}" for i in range(num_layers)]
    return names


def prompt_prefix_key(tokens, length=None):
    """Content hash of the first ``length`` tokens of a prompt (the whole
    prompt when None): the prefix cache's key, the same bytes hashed as
    in the JAX package (int32 tokens, blake2b-128)."""
    a = np.ascontiguousarray(np.asarray(tokens, np.int32).reshape(-1))
    if length is not None:
        a = a[:int(length)]
    return hashlib.blake2b(a.tobytes(), digest_size=16).hexdigest()


class KVPoolExhaustedError(ServerOverloadedError):
    """No free blocks for the allocation right now; carries
    ``needed``/``free``/``capacity`` block counts."""

    def __init__(self, message, needed=None, free=None, capacity=None):
        super().__init__(message)
        self.needed = needed
        self.free = free
        self.capacity = capacity


def _ceil_div(a, b):
    return -(-int(a) // int(b))


class KVBlockPool:
    """Device block pool + host free-list allocator + per-slot tables,
    refcounted for the prefix cache.

    Driven by one thread (the decode loop or an offline ``generate``);
    a lock keeps the accounting consistent for ``stats()`` readers on
    other threads. ``num_blocks`` counts the trash block, so the
    allocatable capacity is ``num_blocks - 1``; the default is the dense
    bank's footprint, ``slots * ceil(max_seq_len / block_size) + 1``.
    ``prefix_cache`` (None: ``FLAGS_kv_prefix_cache``) turns the prefix
    index on. ``device=None`` means the GPU and raises without one.
    ``tp`` > 1: the pool of one tensor-parallel rank, which holds its
    ``num_heads / tp`` heads of every block (``num_heads`` is then the
    pool's heads; the JAX package's ``apply_pool_sharding``): the cache
    never crosses cards. Its migration payloads keep the single-card
    layout: :meth:`export_slot` gathers every rank's heads over the tp
    axis of ``mesh`` (every rank of the group calls it), and
    :meth:`import_slot` takes a whole payload and writes this rank's
    heads of it.
    """

    def __init__(self, *, slots, num_layers, num_heads, d_head,
                 max_seq_len, block_size=None, num_blocks=None, dtype=None,
                 name="serving", prefix_cache=None, device=None, tp=1,
                 mesh=None):
        self.slots = int(slots)
        self.num_layers = int(num_layers)
        self.tp = int(tp or 1)
        self.mesh = mesh
        if int(num_heads) % self.tp:
            raise ValueError(f"tp={self.tp} must divide num_heads="
                             f"{num_heads} (the pool splits on heads)")
        self.num_heads = int(num_heads) // self.tp
        self.d_head = int(d_head)
        self.max_seq_len = int(max_seq_len)
        self.block_size = int(block_size or flag("kv_block_size"))
        if self.block_size < 1:
            raise ValueError("kv_block_size must be >= 1")
        self.dtype = dtype or flag("kv_cache_dtype")
        if self.dtype not in _DTYPES:
            raise ValueError(f"kv_cache_dtype must be one of "
                             f"{tuple(_DTYPES)}, got {self.dtype!r}")
        self.blocks_per_row = _ceil_div(self.max_seq_len, self.block_size)
        if num_blocks is None:
            num_blocks = int(flag("kv_pool_blocks")) or \
                self.slots * self.blocks_per_row + 1
        self.num_blocks = int(num_blocks)
        if self.num_blocks < 2:
            raise ValueError("KVBlockPool needs >= 2 blocks (block 0 is "
                             "the reserved trash block)")
        self.name = str(name)
        self.quantized = self.dtype == "int8"
        self.device = resolve_device(device)
        self.prefix_enabled = bool(flag("kv_prefix_cache")
                                   if prefix_cache is None
                                   else prefix_cache)
        self._lock = threading.Lock()
        self._free = list(range(self.num_blocks - 1, 0, -1))
        self._slot_nblocks = {}        # slot -> blocks held
        self._slot_tokens = {}         # slot -> tokens accounted
        # a block returns to the free list when its LAST owner (a slot's
        # table entry or a prefix entry) releases it
        self._refs = {}                # block -> owners
        self._cache_ref = {}           # block -> prefix-entry owners
        # key -> {"blocks", "tokens", "hits"}; insertion order is LRU
        self._prefix = OrderedDict()
        self.counters = dict.fromkeys(_COUNTERS, 0)
        self.tables = np.zeros((self.slots, self.blocks_per_row), np.int32)
        self._layers = None            # lazy device pool
        with self._lock:
            self._update_gauges_locked()

    # -- sizing -----------------------------------------------------------
    def blocks_for_tokens(self, ntokens):
        return _ceil_div(max(int(ntokens), 0), self.block_size)

    @property
    def capacity_blocks(self):
        return self.num_blocks - 1

    def block_bytes(self):
        """Device bytes per block across layers, K+V, scales included."""
        per = self.num_heads * self.block_size
        n = 2 * self.num_layers * per * self.d_head * _ELEM_BYTES[self.dtype]
        if self.quantized:
            n += 2 * self.num_layers * per * 4
        return n

    def dense_slot_bytes(self):
        """Device bytes ONE dense bank slot costs (fp32, max_seq_len)."""
        return 2 * self.num_layers * self.num_heads * self.max_seq_len \
            * self.d_head * 4

    # -- allocator --------------------------------------------------------
    def _exhausted(self, message, needed, free, slot=None):
        self.counters["alloc_failures"] += 1
        _ALLOC_FAIL.inc(labels=(self.name,))
        _flightrec().record(
            "kv_pool_exhausted", pool=self.name, slot=slot,
            needed_blocks=needed, free_blocks=free,
            capacity_blocks=self.capacity_blocks)
        return KVPoolExhaustedError(message, needed=needed, free=free,
                                    capacity=self.capacity_blocks)

    def check_fits(self, ntokens):
        """Raise :class:`BadRequestError` when ``ntokens`` could never fit
        even in an empty pool (terminal, not backpressure)."""
        need = self.blocks_for_tokens(ntokens)
        if need > self.capacity_blocks:
            raise BadRequestError(
                f"request needs {need} KV blocks ({ntokens} tokens at "
                f"block_size={self.block_size}) but the pool's total "
                f"capacity is {self.capacity_blocks} blocks — it can never "
                f"be admitted; raise FLAGS_kv_pool_blocks")

    def admission_check(self, ntokens, pending_tokens=()):
        """Blocks for ``ntokens`` plus every ``pending_tokens`` entry
        (accepted this round, not yet allocated) must be free now, after
        evicting cold prefix entries, else :class:`KVPoolExhaustedError`.
        Allocates nothing."""
        need = self.blocks_for_tokens(ntokens)
        pending = sum(self.blocks_for_tokens(t) for t in pending_tokens)
        with self._lock:
            if need + pending > len(self._free):
                self._evict_cold_locked(need + pending)
            free = len(self._free)
            if need + pending > free:
                raise self._exhausted(
                    f"KV pool {self.name!r} cannot admit a request of "
                    f"{ntokens} tokens right now: {need} block(s) needed "
                    f"(+{pending} pending this round), {free} free of "
                    f"{self.capacity_blocks} — back off and retry",
                    need + pending, free)

    def alloc(self, slot, ntokens):
        """Grow ``slot``'s allocation to cover ``ntokens`` tokens (no-op
        when it already does; cold prefix entries are evicted when the
        free list is short); returns blocks added. Raises
        :class:`KVPoolExhaustedError` with nothing changed when the
        growth cannot be covered."""
        slot = int(slot)
        need = self.blocks_for_tokens(ntokens)
        with self._lock:
            have = self._slot_nblocks.get(slot, 0)
            add = need - have
            if add > len(self._free):
                self._evict_cold_locked(add)
            if add > len(self._free):
                free = len(self._free)
                raise self._exhausted(
                    f"KV pool {self.name!r} exhausted: slot {slot} needs "
                    f"{add} more block(s) for {ntokens} tokens, {free} "
                    f"free of {self.capacity_blocks}", add, free, slot)
            for j in range(have, need):
                b = self._free.pop()
                self._refs[b] = 1
                self.tables[slot, j] = b
            if add > 0:
                self._slot_nblocks[slot] = need
                self._update_gauges_locked()
            self._slot_tokens[slot] = max(self._slot_tokens.get(slot, 0),
                                          int(ntokens))
        if add > 0:
            _ALLOCATED.inc(add, labels=(self.name,))
        return max(add, 0)

    def ensure(self, slot, pos):
        """Allocation-on-append: the block holding cache slot ``pos``
        exists before the decode step writes there."""
        return self.alloc(slot, int(pos) + 1)

    def free_slot(self, slot):
        """Release every block ``slot`` holds; a block shared with the
        prefix cache or another slot returns to the free list only with
        its last owner. Idempotent. Returns the blocks physically
        freed."""
        slot = int(slot)
        with self._lock:
            n = self._slot_nblocks.pop(slot, 0)
            self._slot_tokens.pop(slot, None)
            freed = self._release_blocks_locked(
                int(b) for b in self.tables[slot, :n])
            self.tables[slot, :] = 0
            if n:
                self._update_gauges_locked()
        if freed:
            _FREED.inc(freed, labels=(self.name,))
        return freed

    def _release_blocks_locked(self, block_ids):
        """Drop one reference per block; free it at refcount 0. Returns
        the blocks freed."""
        freed = 0
        for b in block_ids:
            left = self._refs.get(b, 1) - 1
            if left <= 0:
                self._refs.pop(b, None)
                self._free.append(b)
                freed += 1
            else:
                self._refs[b] = left
        return freed

    def _cached_only_locked(self):
        return sum(1 for b, c in self._cache_ref.items()
                   if c > 0 and self._refs.get(b, 0) == c)

    def blocks_in_use(self):
        """Blocks held by slots. Blocks held only by the prefix cache are
        evictable capital, not load (:meth:`cached_blocks`)."""
        with self._lock:
            return self.capacity_blocks - len(self._free) \
                - self._cached_only_locked()

    def cached_blocks(self):
        """Blocks held only by the prefix cache (evictable)."""
        with self._lock:
            return self._cached_only_locked()

    def holders(self):
        """``{slot: blocks held}`` for every slot holding blocks."""
        with self._lock:
            return dict(self._slot_nblocks)

    def reclaim_leaks(self, live_slots):
        """The leak sweep: free the blocks of every slot not in
        ``live_slots`` (a finished slot should have freed its own).
        Returns the blocks physically freed; shared blocks stay with
        their other owners."""
        live = {int(s) for s in live_slots}
        with self._lock:
            leaked = [(s, n) for s, n in self._slot_nblocks.items()
                      if s not in live and n > 0]
        total = 0
        for slot, held in leaked:
            n = self.free_slot(slot)
            total += n
            _LEAKED.inc(n, labels=(self.name,))
            # shared: table entries whose blocks another owner keeps
            _flightrec().record("kv_block_leak", pool=self.name,
                                slot=slot, blocks=n, shared=held - n)
        self.counters["leaked_blocks"] += total
        return total

    # -- block-granular prefix cache (refcounts + copy-on-write) ----------
    def match_prefix(self, prompt):
        """Longest cached prefix of ``prompt``: the exact prompt first,
        then block-aligned lengths descending. Returns ``{"key",
        "tokens", "blocks"}`` or None; a hit refreshes its LRU place."""
        if not self.prefix_enabled:
            return None
        toks = np.asarray(prompt, np.int32).reshape(-1)
        L = int(toks.size)
        if L < 1:
            return None
        bs = self.block_size
        lengths = [L] + [n for n in range((L // bs) * bs, 0, -bs) if n != L]
        with self._lock:
            for n in lengths:
                key = prompt_prefix_key(toks, n)
                e = self._prefix.get(key)
                if e is None or e["tokens"] != n:
                    continue
                self._prefix.move_to_end(key)
                e["hits"] += 1
                self.counters["prefix_hits"] += 1
                _PREFIX_HITS.inc(labels=(self.name,))
                return {"key": key, "tokens": n, "blocks": list(e["blocks"])}
            self.counters["prefix_misses"] += 1
        _PREFIX_MISSES.inc(labels=(self.name,))
        return None

    def adopt_prefix(self, slot, match):
        """Attach a :meth:`match_prefix` hit's blocks to the empty
        ``slot`` by reference. The adopter owes a :meth:`prepare_write`
        before any write into the adopted range."""
        slot = int(slot)
        blocks = [int(b) for b in match["blocks"]]
        tokens = int(match["tokens"])
        with self._lock:
            if self._slot_nblocks.get(slot, 0):
                raise ValueError(
                    f"KV pool {self.name!r} slot {slot} already holds "
                    f"blocks — free it before adopting a cached prefix")
            for j, b in enumerate(blocks):
                self.tables[slot, j] = b
                self._refs[b] = self._refs.get(b, 0) + 1
            self._slot_nblocks[slot] = len(blocks)
            self._slot_tokens[slot] = tokens
            self.counters["prefix_tokens_reused"] += tokens
            self._update_gauges_locked()
        _PREFIX_TOKENS_REUSED.inc(tokens, labels=(self.name,))
        return len(blocks)

    def prefix_insert(self, prompt, slot):
        """Deposit ``slot``'s prefilled prompt blocks into the index at
        the exact length and, when distinct, the block-aligned one (the
        cache co-owns them, so they outlive the slot until evicted).
        Returns the entries inserted."""
        if not self.prefix_enabled:
            return 0
        toks = np.asarray(prompt, np.int32).reshape(-1)
        L = int(toks.size)
        slot = int(slot)
        if L < 1:
            return 0
        bs = self.block_size
        lengths = [L]
        aligned = (L // bs) * bs
        if aligned and aligned != L:
            lengths.append(aligned)
        inserted = 0
        with self._lock:
            held = self._slot_nblocks.get(slot, 0)
            for n in lengths:
                nb = _ceil_div(n, bs)
                if nb < 1 or nb > held:
                    continue
                key = prompt_prefix_key(toks, n)
                if key in self._prefix:
                    self._prefix.move_to_end(key)
                    continue
                blocks = [int(self.tables[slot, j]) for j in range(nb)]
                if 0 in blocks:
                    continue
                for b in blocks:
                    self._refs[b] = self._refs.get(b, 0) + 1
                    self._cache_ref[b] = self._cache_ref.get(b, 0) + 1
                self._prefix[key] = {"blocks": blocks, "tokens": n,
                                     "hits": 0}
                inserted += 1
            if inserted:
                self._update_gauges_locked()
        return inserted

    def prepare_write(self, slot, start_pos, end_pos):
        """Copy-on-write barrier: every block covering cache positions
        ``[start_pos, end_pos)`` of ``slot`` is made the slot's own
        before a write lands there. Shared blocks are copied into fresh
        ones on the device (in place, one indexed copy per pool tensor)
        and the slot's table re-pointed; the other owners keep the
        originals. Raises :class:`KVPoolExhaustedError`, after evicting
        cold prefixes, with the table unchanged when no block is free
        for a copy. Returns the blocks copied."""
        slot = int(slot)
        start, end = int(start_pos), int(end_pos)
        if end <= start:
            return 0
        bs = self.block_size
        j0, j1 = start // bs, _ceil_div(end, bs)

        def shared():
            return [j for j in range(j0, j1)
                    if self.tables[slot, j] != 0
                    and self._refs.get(int(self.tables[slot, j]), 1) > 1]
        copies = []
        with self._lock:
            js = shared()
            if len(js) > len(self._free):
                # eviction can unshare a block too: scan again
                self._evict_cold_locked(len(js))
                js = shared()
            if len(js) > len(self._free):
                raise self._exhausted(
                    f"KV pool {self.name!r} cannot copy-on-write {len(js)} "
                    f"shared block(s) for slot {slot}: {len(self._free)} "
                    f"free of {self.capacity_blocks}", len(js),
                    len(self._free), slot)
            for j in js:
                b = int(self.tables[slot, j])
                nb = self._free.pop()
                self._refs[b] -= 1
                self._refs[nb] = 1
                self.tables[slot, j] = nb
                copies.append((b, nb))
            self.counters["prefix_cow_copies"] += len(copies)
            if copies:
                self._update_gauges_locked()
        if copies:
            _PREFIX_COW.inc(len(copies), labels=(self.name,))
            self._copy_blocks([a for a, _ in copies], [b for _, b in copies])
        return len(copies)

    def _evict_cold_locked(self, need):
        """Evict LRU prefix entries until ``need`` blocks are free or the
        index is empty. Returns the entries evicted."""
        evicted = 0
        while self._prefix and len(self._free) < need:
            _, e = self._prefix.popitem(last=False)
            for b in e["blocks"]:
                c = self._cache_ref.get(b, 0) - 1
                if c <= 0:
                    self._cache_ref.pop(b, None)
                else:
                    self._cache_ref[b] = c
            freed = self._release_blocks_locked(e["blocks"])
            self.counters["prefix_evictions"] += 1
            if freed:
                _FREED.inc(freed, labels=(self.name,))
            _PREFIX_EVICTIONS.inc(labels=(self.name,))
            _flightrec().record(
                "kv_prefix_evicted", pool=self.name, tokens=e["tokens"],
                blocks=len(e["blocks"]), freed=freed, hits=e["hits"])
            evicted += 1
        if evicted:
            self._update_gauges_locked()
        return evicted

    def _copy_blocks(self, src_ids, dst_ids):
        """Device copy of blocks ``src_ids`` into ``dst_ids`` in every
        pool tensor (scales included), in place."""
        src = torch.as_tensor(src_ids, dtype=torch.long).to(self.device)
        dst = torch.as_tensor(dst_ids, dtype=torch.long).to(self.device)
        for layer in self.layers():
            for t in layer:
                if t is not None:
                    t[dst] = t[src]

    # -- device pool ------------------------------------------------------
    def layers(self):
        """Per layer ``(k_pool, v_pool, k_scale, v_scale)`` (scales None
        unless int8), built as zeros on first use (scales as ones, so a
        never-written slot dequantizes to 0) and written in place from
        then on."""
        if self._layers is None:
            shape = (self.num_blocks, self.num_heads, self.block_size,
                     self.d_head)
            dt, dev = _DTYPES[self.dtype], self.device
            layers = []
            for _ in range(self.num_layers):
                ks = vs = None
                if self.quantized:
                    ks = torch.ones(shape[:3], device=dev)
                    vs = torch.ones(shape[:3], device=dev)
                layers.append((torch.zeros(shape, dtype=dt, device=dev),
                               torch.zeros(shape, dtype=dt, device=dev),
                               ks, vs))
            self._layers = layers
        return self._layers

    def tensors(self):
        """Every device tensor of the pool, in one fixed order (what a
        captured decode graph holds the addresses of)."""
        return [t for layer in self.layers() for t in layer
                if t is not None]

    def view(self):
        """The pool as one decode step sees it: its device arrays and
        block tables as they are now (:class:`PoolView`)."""
        return PoolView(self)

    def drop_device(self):
        """Release the device pool; the next :meth:`layers` builds it
        anew (and every graph over the old one is captured again). Host
        accounting is untouched. Returns the released arrays (None if
        none were built)."""
        released, self._layers = self._layers, None
        return released

    def reset(self):
        """Free every block, clear the prefix index and release the
        device pool."""
        with self._lock:
            self._free = list(range(self.num_blocks - 1, 0, -1))
            self._slot_nblocks.clear()
            self._slot_tokens.clear()
            self._refs.clear()
            self._cache_ref.clear()
            self._prefix.clear()
            self.tables[:] = 0
            self._layers = None
            self._update_gauges_locked()

    def device_tables(self, rows=None):
        """The block tables (rows ``rows``, default all) as an int32
        device tensor."""
        t = self.tables if rows is None else self.tables[list(rows)]
        return torch.from_numpy(np.ascontiguousarray(t)).to(self.device)

    def scatter_prefill(self, slot_ids, ks, vs, bucket_len):
        """Move freshly prefilled keys/values into the pool: rows
        ``slot_ids`` of the tables receive the first ``bucket_len``
        positions of ``ks[i][:len(slot_ids)]``/``vs[i]`` (``[n, H, S, D]``,
        S >= bucket_len), reshaped into blocks and written through the
        block table in place. Table entries past a row's allocation name
        the trash block, so bucket padding lands there. Quantizes on the
        way in for an int8 pool."""
        n = len(slot_ids)
        bs = self.block_size
        nblk = self.blocks_for_tokens(bucket_len)
        cover = nblk * bs
        blocks = torch.from_numpy(np.ascontiguousarray(
            self.tables[np.asarray(slot_ids, np.int64), :nblk]).reshape(-1)
        ).to(self.device).long()                           # [n * nblk]
        for (pk, pv, pks, pvs), k, v in zip(self.layers(), ks, vs):
            for pool, sc, src in ((pk, pks, k), (pv, pvs, v)):
                vals = src[:n, :, :min(cover, src.shape[2])]
                if vals.shape[2] < cover:
                    vals = torch.nn.functional.pad(
                        vals, (0, 0, 0, cover - vals.shape[2]))
                H, D = vals.shape[1], vals.shape[3]
                vals = vals.reshape(n, H, nblk, bs, D).permute(
                    0, 2, 1, 3, 4).reshape(n * nblk, H, bs, D)
                if self.quantized:
                    qv, s = quantize_kv(vals)
                    pool[blocks] = qv
                    sc[blocks] = s
                else:
                    pool[blocks] = vals.to(pool.dtype)

    # -- migration (disaggregated prefill / decode) -----------------------
    def export_slot(self, slot):
        """``slot``'s allocated blocks as a wire-safe payload: the
        geometry fields and per layer ``k_i``/``v_i`` ``[nblocks, H,
        block_size, D]`` (bf16 as uint16 bits; ``ks_i``/``vs_i`` float32
        scales for int8). Raises ``ValueError`` when the slot holds
        nothing."""
        slot = int(slot)
        with self._lock:
            n = int(self._slot_nblocks.get(slot, 0))
            tokens = int(self._slot_tokens.get(slot, 0))
            ids = self.tables[slot, :n].astype(np.int64)
        if n == 0:
            raise ValueError(f"KV pool {self.name!r} slot {slot} holds no "
                             f"blocks — nothing to export")
        idx = torch.from_numpy(ids).to(self.device)
        payload = {"fmt": KV_WIRE_FMT, "pool_dtype": self.dtype,
                   "block_size": self.block_size,
                   "num_layers": self.num_layers,
                   "num_heads": self.num_heads * self.tp,
                   "d_head": self.d_head, "tokens": tokens, "nblocks": n}
        for i, (pk, pv, pks, pvs) in enumerate(self.layers()):
            for kind, pool, sc in (("k", pk, pks), ("v", pv, pvs)):
                a = self._whole_heads(pool[idx])
                if self.dtype == "bf16":
                    a = a.view(torch.int16)
                payload[f"{kind}_{i}"] = a.cpu().numpy().view(
                    _WIRE_NP[self.dtype])
                if self.quantized:
                    payload[f"{kind}s_{i}"] = \
                        self._whole_heads(sc[idx]).cpu().numpy()
        self.counters["blocks_exported"] += n
        _EXPORTED.inc(n, labels=(self.name,))
        return payload

    def _whole_heads(self, a):
        """``a`` (``[n, heads of this rank, ...]``) with every rank's
        heads, in rank order (a gather over the tp axis at tp > 1)."""
        if self.tp == 1:
            return a
        from ..ops.collective_ops import all_gather
        return all_gather(a.contiguous(), "tp", 1, mesh=self.mesh)

    def _my_heads(self, a):
        """This rank's heads of a whole payload array ``a`` (dim 1)."""
        if self.tp == 1:
            return a
        r = self.mesh.coords()["tp"] if self.mesh is not None else 0
        return a[:, r * self.num_heads:(r + 1) * self.num_heads]

    @staticmethod
    def payload_bytes(payload):
        """Array bytes a migration payload carries."""
        return int(sum(a.nbytes for a in payload.values()
                       if isinstance(a, np.ndarray)))

    def import_slot(self, slot, payload):
        """Write a migrated payload into ``slot``: the geometry is checked
        against this pool (a mismatch is a :class:`BadRequestError`:
        retrying cannot help), the blocks are allocated (typed
        :class:`KVPoolExhaustedError` with nothing held), then the arrays
        are written through the fresh table entries in place. Returns the
        blocks imported."""
        slot = int(slot)
        tokens, n = self._validate_payload(payload)
        self.alloc(slot, tokens)
        try:
            with self._lock:
                ids = self.tables[slot, :n].astype(np.int64)
            idx = torch.from_numpy(ids).to(self.device)
            for i, (pk, pv, pks, pvs) in enumerate(self.layers()):
                for kind, pool, sc in (("k", pk, pks), ("v", pv, pvs)):
                    a = np.ascontiguousarray(
                        self._my_heads(payload[f"{kind}_{i}"]))
                    t = torch.from_numpy(a.view(np.int16)).view(
                        torch.bfloat16) if self.dtype == "bf16" \
                        else torch.from_numpy(a)
                    pool[idx] = t.to(self.device)
                    if self.quantized:
                        sc[idx] = torch.from_numpy(np.ascontiguousarray(
                            self._my_heads(payload[f"{kind}s_{i}"]))).to(
                                self.device)
        except Exception:
            self.free_slot(slot)
            raise
        self.counters["blocks_imported"] += n
        _IMPORTED.inc(n, labels=(self.name,))
        return n

    def _validate_payload(self, payload):
        """Geometry, type and shape checks of a migration payload; returns
        ``(tokens, nblocks)``. Every refusal is a :class:`BadRequestError`."""
        if not isinstance(payload, dict) \
                or payload.get("fmt") != KV_WIRE_FMT:
            got = payload.get("fmt") if isinstance(payload, dict) \
                else type(payload).__name__
            raise BadRequestError(f"KV payload format {got!r} is not "
                                  f"{KV_WIRE_FMT!r}")
        heads = self.num_heads * self.tp        # the single-card layout
        for field, mine in (("pool_dtype", self.dtype),
                            ("block_size", self.block_size),
                            ("num_layers", self.num_layers),
                            ("num_heads", heads),
                            ("d_head", self.d_head)):
            if payload.get(field) != mine:
                raise BadRequestError(
                    f"KV payload {field}={payload.get(field)!r} does not "
                    f"match the receiving pool's {mine!r} — prefill and "
                    f"decode replicas must share the cache geometry")
        try:
            tokens = int(payload["tokens"])
            n = int(payload["nblocks"])
        except (KeyError, TypeError, ValueError):
            raise BadRequestError("KV payload lacks integer tokens/nblocks "
                                  "fields") from None
        if tokens < 1 or n != self.blocks_for_tokens(tokens):
            raise BadRequestError(
                f"KV payload claims {tokens} tokens in {n} blocks; "
                f"{self.blocks_for_tokens(tokens)} blocks expected at "
                f"block_size={self.block_size}")
        if tokens > self.max_seq_len:
            raise BadRequestError(
                f"KV payload holds {tokens} tokens but the receiving "
                f"pool's rows cap at max_seq_len={self.max_seq_len}")
        shape = (n, heads, self.block_size, self.d_head)
        want = [(f"{kind}_{i}", shape, _WIRE_NP[self.dtype])
                for i in range(self.num_layers) for kind in ("k", "v")]
        if self.quantized:
            want += [(f"{kind}s_{i}", shape[:3], np.float32)
                     for i in range(self.num_layers) for kind in ("k", "v")]
        for key, shp, dt in want:
            a = payload.get(key)
            if not isinstance(a, np.ndarray) or tuple(a.shape) != shp \
                    or a.dtype != dt:
                raise BadRequestError(
                    f"KV payload array {key} is "
                    f"{getattr(a, 'shape', None)} "
                    f"{getattr(a, 'dtype', None)}, expected {shp} "
                    f"{np.dtype(dt)}")
        return tokens, n

    # -- reporting --------------------------------------------------------
    def digest(self):
        """A hash of the host-side bookkeeping: the free list in its
        order, the block tables, the slots' blocks and tokens, the
        refcounts, the prefix index (keys, blocks, tokens and hits, in
        LRU order) and the event counters. Two pools driven by the same
        calls have the same digest (the ranks of a tp group compare
        theirs)."""
        with self._lock:
            state = (self._free, self.tables.tobytes(),
                     sorted(self._slot_nblocks.items()),
                     sorted(self._slot_tokens.items()),
                     sorted(self._refs.items()),
                     sorted(self._cache_ref.items()),
                     [(k, e["blocks"], e["tokens"], e["hits"])
                      for k, e in self._prefix.items()],
                     sorted(self.counters.items()))
            raw = repr(state).encode()
        return hashlib.blake2b(raw, digest_size=16).hexdigest()

    def _update_gauges_locked(self):
        lab = (self.name,)
        cached = self._cached_only_locked()
        in_use = self.capacity_blocks - len(self._free) - cached
        _BLOCKS_IN_USE.set(in_use, labels=lab)
        _CAPACITY.set(self.capacity_blocks, labels=lab)
        # occupancy counts slot load only: blocks held just by the
        # prefix cache are evictable working capital
        _OCCUPANCY.set(in_use / self.capacity_blocks
                       if self.capacity_blocks else 0.0, labels=lab)
        _SAVED.set(self.slots * self.dense_slot_bytes()
                   - (in_use + cached) * self.block_bytes(), labels=lab)
        _PREFIX_ENTRIES.set(len(self._prefix), labels=lab)
        _PREFIX_BLOCKS.set(cached, labels=lab)

    def stats(self):
        """Occupancy / fragmentation / prefix-cache snapshot (plain ints
        and floats)."""
        with self._lock:
            cached = self._cached_only_locked()
            in_use = self.capacity_blocks - len(self._free) - cached
            tokens = sum(self._slot_tokens.values())
            slots_held = sum(1 for n in self._slot_nblocks.values() if n)
            entries = len(self._prefix)
            counters = dict(self.counters)
        cap_tokens = in_use * self.block_size
        out = {
            "blocks": self.num_blocks,
            "block_size": self.block_size,
            "dtype": self.dtype,
            "capacity_blocks": self.capacity_blocks,
            "blocks_in_use": in_use,
            "blocks_free": self.capacity_blocks - in_use,
            "occupancy": round(in_use / self.capacity_blocks, 4)
            if self.capacity_blocks else 0.0,
            "fragmentation": round(1.0 - tokens / cap_tokens, 4)
            if cap_tokens else 0.0,
            "tokens_held": tokens,
            "slots_holding_blocks": slots_held,
            "prefix_entries": entries,
            "evictable_blocks": cached,
            "bytes_in_use": (in_use + cached) * self.block_bytes(),
            "bytes_capacity": self.capacity_blocks * self.block_bytes(),
            "saved_vs_dense_bytes": self.slots * self.dense_slot_bytes()
            - (in_use + cached) * self.block_bytes(),
        }
        out.update(counters)
        return out
