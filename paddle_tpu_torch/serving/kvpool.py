"""Block-paged KV-cache pool: decode memory priced by the tokens a slot
actually holds.

Counterpart of ``paddle_tpu/serving/kvpool.py`` (``KVBlockPool``), cut to
the allocator and the device pool: a LIFO free-list of fixed-size blocks
shared by every slot, a per-slot block table, blocks allocated on append
and returned when a row finishes. Block 0 is the reserved TRASH block:
table entries past a row's allocation name it, so padded prefill
scatters and free slots write garbage somewhere position masks never
read. Exhaustion raises the typed :class:`KVPoolExhaustedError`
(a ``ServerOverloadedError``: the client backs off).

The device side is one ``[num_blocks, H, block_size, D]`` tensor per
layer for K and for V (float32, bfloat16, or int8 with float32 scales
``[num_blocks, H, block_size]``), written in place by the decode step
and by :meth:`KVBlockPool.scatter_prefill`.
"""
import threading

import numpy as np
import torch

from ..device import resolve_device
from ..flags import flag
from ..kernels.paged_attention import quantize_kv
from .batching import BadRequestError, ServerOverloadedError

_DTYPES = {"fp32": torch.float32, "bf16": torch.bfloat16,
           "int8": torch.int8}
_ELEM_BYTES = {"fp32": 4, "bf16": 2, "int8": 1}


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
    """Device block pool + host free-list allocator + per-slot tables.

    Driven by one thread (the decode loop or an offline ``generate``);
    a lock keeps the accounting consistent for ``stats()`` readers on
    other threads. ``num_blocks`` counts the trash block, so the
    allocatable capacity is ``num_blocks - 1``; the default is the dense
    bank's footprint, ``slots * ceil(max_seq_len / block_size) + 1``.
    ``device=None`` means the GPU and raises without one.
    """

    def __init__(self, *, slots, num_layers, num_heads, d_head,
                 max_seq_len, block_size=None, num_blocks=None, dtype=None,
                 device=None):
        self.slots = int(slots)
        self.num_layers = int(num_layers)
        self.num_heads = int(num_heads)
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
        self.quantized = self.dtype == "int8"
        self.device = resolve_device(device)
        self._lock = threading.Lock()
        self._free = list(range(self.num_blocks - 1, 0, -1))
        self._slot_nblocks = {}        # slot -> blocks held
        self._slot_tokens = {}         # slot -> tokens accounted
        self.tables = np.zeros((self.slots, self.blocks_per_row), np.int32)
        self._layers = None            # lazy device pool

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

    # -- allocator --------------------------------------------------------
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
        (accepted this round, not yet allocated) must be free now, else
        :class:`KVPoolExhaustedError`. Allocates nothing."""
        need = self.blocks_for_tokens(ntokens)
        pending = sum(self.blocks_for_tokens(t) for t in pending_tokens)
        with self._lock:
            free = len(self._free)
        if need + pending > free:
            raise KVPoolExhaustedError(
                f"KV pool cannot admit a request of {ntokens} tokens right "
                f"now: {need} block(s) needed (+{pending} pending this "
                f"round), {free} free of {self.capacity_blocks} — back off "
                f"and retry", needed=need + pending, free=free,
                capacity=self.capacity_blocks)

    def alloc(self, slot, ntokens):
        """Grow ``slot``'s allocation to cover ``ntokens`` tokens (no-op
        when it already does); returns blocks added. Raises
        :class:`KVPoolExhaustedError` with nothing changed when the free
        list cannot cover the growth."""
        slot = int(slot)
        need = self.blocks_for_tokens(ntokens)
        with self._lock:
            have = self._slot_nblocks.get(slot, 0)
            add = need - have
            if add > len(self._free):
                free = len(self._free)
                raise KVPoolExhaustedError(
                    f"KV pool exhausted: slot {slot} needs {add} more "
                    f"block(s) for {ntokens} tokens, {free} free of "
                    f"{self.capacity_blocks}", needed=add, free=free,
                    capacity=self.capacity_blocks)
            for j in range(have, need):
                self.tables[slot, j] = self._free.pop()
            if add > 0:
                self._slot_nblocks[slot] = need
            self._slot_tokens[slot] = max(self._slot_tokens.get(slot, 0),
                                          int(ntokens))
        return max(add, 0)

    def ensure(self, slot, pos):
        """Allocation-on-append: the block holding cache slot ``pos``
        exists before the decode step writes there."""
        return self.alloc(slot, int(pos) + 1)

    def free_slot(self, slot):
        """Return every block ``slot`` holds; idempotent. Returns the
        number of blocks freed."""
        slot = int(slot)
        with self._lock:
            n = self._slot_nblocks.pop(slot, 0)
            self._slot_tokens.pop(slot, None)
            self._free.extend(int(b) for b in self.tables[slot, :n])
            self.tables[slot, :] = 0
        return n

    def blocks_in_use(self):
        with self._lock:
            return self.capacity_blocks - len(self._free)

    # -- device pool ------------------------------------------------------
    def layers(self):
        """Per layer ``(k_pool, v_pool, k_scale, v_scale)`` (scales None
        unless int8), built as zeros on first use (scales as ones, so a
        never-written slot dequantizes to 0)."""
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

    def drop_device(self):
        """Forget the device pool; the next :meth:`layers` rebuilds it.
        Host accounting is untouched."""
        self._layers = None

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

    # -- reporting --------------------------------------------------------
    def stats(self):
        """Occupancy / fragmentation snapshot (plain ints and floats)."""
        with self._lock:
            in_use = self.capacity_blocks - len(self._free)
            tokens = sum(self._slot_tokens.values())
            slots_held = sum(1 for n in self._slot_nblocks.values() if n)
        cap_tokens = in_use * self.block_size
        return {
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
            "bytes_in_use": in_use * self.block_bytes(),
            "bytes_capacity": self.capacity_blocks * self.block_bytes(),
        }
