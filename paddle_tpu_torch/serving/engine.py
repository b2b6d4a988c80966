"""Slot-batched decoding primitives for the serving runtime.

Counterpart of ``paddle_tpu/serving/engine.py`` (``GenerationEngine``).
The engine owns a fixed bank of ``slots`` generation rows over a
``models.generation.GPTGenerator``: either a dense bank (one
``[slots, H, max_len, D]`` cache per layer) or, with ``paged=True``, a
shared ``KVBlockPool`` with per-slot block tables. The ``DecodeBatcher``
thread is its only caller:

- ``admit(requests, slot_ids)``: bucketed prefill over the new prompts,
  sampling of their first tokens, and the write of their keys/values
  into their slots.
- ``prepare_step(active_pos)``: allocation-on-append before a step
  (paged); returns the rows the pool could not grow.
- ``step(tokens, pos, temperature, top_k)``: one decode + sample over
  the whole bank; rows at different positions share the step.
- ``release_slot(slot)``: a finished row returns its blocks (paged).
"""
import numpy as np

from ..flags import flag
from .batching import BadRequestError


class GenerationEngine:
    def __init__(self, generator, *, slots=None, stats=None, seed=0,
                 paged=None):
        self.gen = generator
        self.slots = int(slots or flag("decode_slots"))
        self.stats = stats if stats is not None else generator.stats
        if generator.stats is None:
            generator.stats = self.stats
        self.max_len = generator.max_len
        self.paged = bool(flag("kv_paged") if paged is None else paged)
        self.pool = None
        self._caches = None            # dense bank, built lazily
        if self.paged:
            from .kvpool import KVBlockPool
            cfg = generator.cfg
            self.pool = KVBlockPool(
                slots=self.slots, num_layers=cfg.num_layers,
                num_heads=cfg.num_heads, d_head=cfg.d_head,
                max_seq_len=self.max_len, device=generator.device)
        self._rng = generator.new_rng(seed)

    def _bank(self):
        if self._caches is None:
            self._caches = self.gen.new_dense_caches(self.slots)
        return self._caches

    # -- admission / lifecycle --------------------------------------------
    def admission_check(self, prompt_len, max_new_tokens, pending_tokens=(),
                        static_only=False):
        """Typed gate: an overlong request (or one the pool could never
        hold) raises :class:`BadRequestError`; in paged mode a request
        whose prompt blocks are not free right now (unless
        ``static_only``) raises the retryable ``KVPoolExhaustedError``,
        counting ``pending_tokens`` accepted earlier this round."""
        prompt_len, max_new_tokens = int(prompt_len), int(max_new_tokens)
        if prompt_len + max_new_tokens > self.max_len:
            raise BadRequestError(
                f"prompt ({prompt_len} tokens) + max_new_tokens "
                f"({max_new_tokens}) exceeds the decode cache length "
                f"{self.max_len}")
        if self.pool is not None:
            self.pool.check_fits(prompt_len + max_new_tokens)
            if not static_only:
                # +1: the first decode append may open a fresh block
                self.pool.admission_check(
                    prompt_len + 1, [int(t) + 1 for t in pending_tokens])

    def release_slot(self, slot):
        """Return a finished slot's blocks (dense: nothing to do, the
        row is overwritten by its next occupant)."""
        if self.pool is not None:
            self.pool.free_slot(slot)

    def prepare_step(self, active_pos):
        """Grow each live row's blocks to cover the slot its next token
        writes (``active_pos``: slot -> position). Returns
        ``{slot: exc}`` for rows the pool could not grow; dense: {}."""
        if self.pool is None:
            return {}
        shed = {}
        for slot, p in active_pos.items():
            try:
                self.pool.ensure(slot, int(p))
            except Exception as exc:  # noqa: BLE001 — per-row shed
                shed[slot] = exc
        return shed

    def admit(self, requests, slot_ids):
        """Prefill the requests' prompts as one bucketed batch, sample
        their first tokens, write their keys/values into ``slot_ids``.
        Returns the first tokens, np.int32 ``[len(requests)]``."""
        n = len(requests)
        tokens, pos_ids, last = self.gen._pack_prompts(
            [req.prompt for req in requests])
        bb, s = tokens.shape
        temp = np.zeros((bb,), np.float32)
        topk = np.zeros((bb,), np.int32)
        for r, req in enumerate(requests):
            temp[r] = req.temperature
            topk[r] = req.top_k
        if self.pool is not None:
            allocated = []
            try:
                for req, slot in zip(requests, slot_ids):
                    self.pool.free_slot(slot)     # stale holder (if any)
                    self.pool.alloc(slot, int(req.prompt.size))
                    allocated.append(slot)
            except Exception:
                for sl in allocated:
                    self.pool.free_slot(sl)
                raise
        try:
            logits, ks, vs = self.gen.run_prefill(tokens, pos_ids, last)
            toks = self.gen.run_sample(logits, temp, topk, self._rng)
            if self.pool is not None:
                self.pool.scatter_prefill(list(slot_ids), ks, vs, s)
            else:
                cache_k, cache_v = self._bank()
                for c, new in zip(cache_k + cache_v, ks + vs):
                    c[list(slot_ids), :, :s] = new[:n]
        except Exception:
            for sl in slot_ids:
                self.release_slot(sl)
            raise
        return toks[:n]

    def step(self, tokens, pos, temperature, top_k):
        """One decode + sample over the whole bank. Arrays of length
        ``slots`` (free slots carry stale values whose rows nobody
        reads). Returns np.int32 tokens ``[slots]``."""
        tok = np.ascontiguousarray(tokens, dtype=np.int32)
        posc = np.ascontiguousarray(pos, dtype=np.int32)
        if self.pool is not None:
            logits = self.gen.run_decode_paged(tok, posc, self.pool)
        else:
            cache_k, cache_v = self._bank()
            logits = self.gen.run_decode(tok, posc, cache_k, cache_v)
        return self.gen.run_sample(logits, temperature, top_k, self._rng)
