"""The serving engines: ``ServingEngine`` (a saved inference model run
as padded batches of captured programs) and ``GenerationEngine``
(slot-batched decoding).

Counterpart of ``paddle_tpu/serving/engine.py``.

``ServingEngine`` loads a saved inference model once (``io``), runs the
program through the executor's pass pipeline, and keeps one
:class:`~paddle_tpu_torch.framework.cuda_graph.CapturedProgram` per feed
signature in a byte- and entry-capped ``ExecutableCache``: on the GPU a
CUDA graph, all of one engine's graphs in one graph memory pool; on the
CPU the optimized program run eagerly. ``execute(requests)`` is the
``MicroBatcher``'s flush target: it concatenates the requests' rows,
pads them to the power-of-two bucket, runs that bucket's entry and
slices each request's rows back. Hot weight reload
(``load_state_snapshot``/``swap_state``) is not ported.

``GenerationEngine`` owns a fixed bank of ``slots`` generation rows over
a ``models.generation.GPTGenerator``: either a dense bank (one
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
import os
import threading
import time

import numpy as np

from ..flags import flag
from .batching import BadRequestError, next_bucket
from .cache import ExecutableCache, feed_signature

SIGNATURE_FILE = "_serving_signatures.json"


class ServingEngine:
    """A saved inference model (``model_dir``, or a loaded ``program``
    with its ``scope``, ``feed_names`` and ``fetch_targets``) executed
    as padded batches of captured programs on ``place`` (None: the
    GPU)."""

    def __init__(self, model_dir=None, *, program=None, scope=None,
                 feed_names=None, fetch_targets=None, model_filename=None,
                 params_filename=None, cache=None, stats=None, place=None):
        from ..framework.executor import Executor, Scope
        self._exe = Executor(place)
        self.device = self._exe.device
        if program is None:
            if model_dir is None:
                raise ValueError("ServingEngine needs model_dir= or a "
                                 "loaded program=")
            from .. import io as fluid_io
            scope = scope or Scope()
            program, feed_names, fetch_targets = \
                fluid_io.load_inference_model(
                    model_dir, self._exe, model_filename=model_filename,
                    params_filename=params_filename, scope=scope)
        elif scope is None:
            raise ValueError("a loaded program= needs the scope= that "
                             "holds its state")
        self.model_dir = model_dir
        self.program = program
        self.scope = scope
        self.feed_names = list(feed_names)
        self.fetch_names = [t.name if hasattr(t, "name") else str(t)
                            for t in fetch_targets]
        self.stats = stats
        self.cache = cache if cache is not None else ExecutableCache()
        self._optimized = self._exe._optimize(program, self.fetch_names,
                                              self.feed_names, scope)
        self._pool = self._stream = None      # one graph pool, one stream
        self._lock = threading.RLock()
        gb = program.global_block()
        # batching across requests is sound only when every feed's
        # leading dim is dynamic (-1); a static-batch model runs request
        # by request at its natural shape
        self.batchable = all(
            (gb.vars.get(n) is None
             or not getattr(gb.vars[n], "shape", None)
             or int(gb.vars[n].shape[0]) < 0)
            for n in self.feed_names)
        # which fetches are per-row, decided from the program: a dynamic
        # (-1) leading dim scales with the batch and is sliced back per
        # request; anything else is batch-global and replicated. None:
        # unknown in the IR, decided from the output's leading dim.
        self._row_aligned = []
        for n in self.fetch_names:
            var = gb.vars.get(n)
            shape = getattr(var, "shape", None) if var is not None else None
            self._row_aligned.append(
                None if not shape else int(shape[0]) < 0)

    # -- requests ---------------------------------------------------------
    def check_feeds(self, feeds):
        """Raise :class:`BadRequestError` unless ``feeds`` names exactly
        the model's feeds, each in its declared dtype and with its
        declared trailing dims."""
        names = set(feeds)
        missing = [n for n in self.feed_names if n not in names]
        unknown = sorted(names - set(self.feed_names))
        if missing or unknown:
            raise BadRequestError(f"the model feeds {self.feed_names}: "
                                  f"missing {missing}, unknown {unknown}")
        gb = self.program.global_block()
        for n in self.feed_names:
            a = np.asarray(feeds[n])
            var = gb.vars.get(n)
            if var is None:
                continue
            if str(a.dtype) != var.dtype:
                raise BadRequestError(f"feed {n!r} is {a.dtype}, the model "
                                      f"takes {var.dtype}")
            want = tuple(var.shape or ())
            if len(want) != a.ndim or any(
                    w >= 0 and w != d for w, d in zip(want[1:],
                                                      a.shape[1:])):
                raise BadRequestError(f"feed {n!r} has shape {a.shape}, "
                                      f"the model takes {list(want)}")

    # -- captured programs ------------------------------------------------
    def _compile(self, feed):
        """Capture the program at ``feed``'s signature and cache it."""
        from .. import kernels
        from ..framework.cuda_graph import CapturedProgram
        t0 = time.perf_counter()
        if self.device.type == "cuda" and self._pool is None:
            import torch
            self._pool = torch.cuda.graph_pool_handle()
            self._stream = torch.cuda.Stream(device=self.device)
        entry = CapturedProgram(self._optimized, feed, self.fetch_names,
                                self.scope, self.device, pool=self._pool,
                                stream=self._stream,
                                counters=kernels.COUNTED)
        dt = time.perf_counter() - t0
        self.cache.put(feed_signature(feed), entry, nbytes=entry.nbytes)
        if self.stats:
            self.stats.bump("compiles")
            self.stats.hist["compile"].observe(dt)
        return entry

    def entry_for(self, feed):
        """The cached entry of ``feed``'s signature, captured on a miss."""
        with self._lock:
            entry = self.cache.get(feed_signature(feed))
            return entry if entry is not None else self._compile(feed)

    def run(self, feeds):
        """One feed dict as it is (no padding, no batching across
        requests): the fetches as numpy arrays."""
        feed = {n: np.ascontiguousarray(feeds[n]) for n in self.feed_names}
        with self._lock:
            return self.entry_for(feed).run(feed)

    def pad_batch(self, requests):
        """``(feed, rows, bucket)``: the requests' rows concatenated and
        padded with zeros to the power-of-two bucket."""
        total = sum(r.rows for r in requests)
        bucket = next_bucket(total)
        feed = {}
        for name in self.feed_names:
            parts = [r.feeds[name] for r in requests]
            arr = parts[0] if len(parts) == 1 else np.concatenate(parts)
            if bucket > total:
                pad = np.zeros((bucket - total,) + arr.shape[1:],
                               dtype=arr.dtype)
                arr = np.concatenate([arr, pad])
            feed[name] = np.ascontiguousarray(arr)
        return feed, total, bucket

    def execute(self, requests):
        """Execute a same-signature group of requests as one padded
        batch and deliver each request its rows (the MicroBatcher's
        flush target; a batch-level failure raises to it)."""
        live = [r for r in requests if not r.done()]
        if not live:
            return
        if not self.batchable:
            for req in live:
                try:
                    outs = self.run(req.feeds)
                except Exception as exc:  # noqa: BLE001 — this request's
                    req.set_error(exc)
                    if self.stats:
                        self.stats.bump("requests_failed")
                    continue
                self._deliver(req, outs)
                if self.stats:
                    self.stats.observe_batch(req.rows, req.rows)
            return
        t0 = time.perf_counter()
        feed, total, bucket = self.pad_batch(live)
        if self.stats:
            self.stats.hist["pad"].observe(time.perf_counter() - t0)
        with self._lock:
            entry = self.entry_for(feed)
            t1 = time.perf_counter()
            outs = entry.run(feed)
        if self.stats:
            self.stats.hist["execute"].observe(time.perf_counter() - t1)
            self.stats.observe_batch(total, bucket)
        off = 0
        for req in live:
            res = []
            for o, aligned in zip(outs, self._row_aligned):
                if aligned is None:
                    aligned = bool(o.ndim) and o.shape[0] == bucket
                # a batch-global output goes to every request whole
                res.append(o[off:off + req.rows] if aligned else o)
            off += req.rows
            self._deliver(req, res)

    def _deliver(self, req, result):
        req.set_result(result)
        if self.stats:
            self.stats.bump("requests_completed")
            self.stats.hist["total"].observe(
                time.monotonic() - req.t_enqueue)

    def load_state_snapshot(self, dirname):
        raise NotImplementedError("paddle_tpu_torch: hot weight reload "
                                  "(load_state_snapshot/swap_state) is not "
                                  "ported")

    swap_state = load_state_snapshot

    # -- warmup -----------------------------------------------------------
    def feed_specs(self, batch_size=None):
        """``{name: (shape, dtype)}`` of warmup feeds: dynamic dims
        become ``batch_size`` (leading) or 1 (others). The save-time
        record (``program._feed_specs``) first, else the feed vars."""
        gb = self.program.global_block()
        recorded = getattr(self.program, "_feed_specs", None) or {}
        specs = {}
        for n in self.feed_names:
            rec = recorded.get(n)
            if rec and rec.get("shape"):
                shape = [int(d) for d in rec["shape"]]
                dt = rec.get("dtype") or "float32"
            else:
                var = gb.vars.get(n)
                shape = [int(d)
                         for d in getattr(var, "shape", None) or (1,)]
                dt = getattr(var, "dtype", None) or "float32"
            for i, d in enumerate(shape):
                if d < 0:
                    shape[i] = int(batch_size or 1) if i == 0 else 1
            specs[n] = (tuple(shape), np.dtype(dt).name)
        return specs

    def warmup(self, batch_sizes=(1,), signature_file=None):
        """Capture before taking traffic: one entry per bucket of
        ``batch_sizes`` (from the model's feed specs) and one per
        signature in ``signature_file`` (``True``: the model dir's
        ``record_signatures`` file). A signature that fails to capture
        raises; only an unreadable signature file is passed over, with a
        warning. Returns the number of captures."""
        sigs = [self.feed_specs(batch_size=next_bucket(b))
                for b in batch_sizes or ()]
        if signature_file:
            path = signature_file
            if path is True and self.model_dir:
                path = os.path.join(self.model_dir, SIGNATURE_FILE)
            if isinstance(path, str) and os.path.exists(path):
                sigs.extend(ExecutableCache.load_signatures(path))
        n = 0
        for spec in sigs:
            feed = {name: np.zeros(shape, dtype=dtype)
                    for name, (shape, dtype) in spec.items()}
            with self._lock:
                if feed_signature(feed) not in self.cache:
                    self._compile(feed)
                    n += 1
        return n

    def record_signatures(self, path=None):
        """Write the cache's observed signatures for the next launch's
        warmup; default ``<model_dir>/_serving_signatures.json``."""
        if path is None:
            if not self.model_dir:
                raise ValueError("record_signatures needs a path when the "
                                 "engine was not loaded from a model_dir")
            path = os.path.join(self.model_dir, SIGNATURE_FILE)
        self.cache.record(path)
        return path


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
