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
slices each request's rows back.

Hot weight reload: :func:`load_param_snapshot` reads and verifies a
``save_params``-layout checkpoint against its manifest on the host
(every file checked, every shape and dtype the live one's) before
anything changes. The captured graphs read the model's tensors at fixed
addresses, so a swap is no rebind: the new values are staged on the
device off the serving loop (``load_state_snapshot``, ``stage_params``)
and then copied in place, one ``copy_`` a tensor, between micro-batches
(``swap_state``, under the engine's lock) or between decode steps
(``apply_params``, on the decode loop): a replay in flight finishes on
the old weights and every later one reads the new.

``GenerationEngine`` owns a fixed bank of ``slots`` generation rows over
a ``models.generation.GPTGenerator``: a dense bank or a shared
``KVBlockPool``, stepped by a captured decode graph, with chunked
prefill, the prefix cache, KV export and import and speculative steps
(its docstring lists the calls the ``DecodeBatcher`` makes). A decode
step runs under a watchdog (``budget``) on the engine's long-lived
``WatchdogWorker`` thread, over a view of the bank taken when the step
is handed out (``KVBlockPool.view``: the pool's device arrays and block
tables as they are then). A trip releases the bank (``_drop_bank``: the
pool's device arrays and the decode graphs over them; the next
admission builds and captures anew), keeps the released arrays alive
until the abandoned worker ends, and flags ``bank_lost``: a step that
wakes up late writes only into the released arrays, never the live
bank.

Fault points: ``serving.compile``, ``serving.execute`` (infer),
``serving.prefill``, ``serving.slot_insert`` and ``serving.decode_step``
(generation; the last inside the watchdogged step, before the decode
graph's lock).

Telemetry: a traced request's ``serving/pad``, ``serving/compile`` and
``serving/execute`` spans (infer), ``serving/prefill``,
``serving/prefill_chunked`` and ``serving/kv_import`` (generation); each
executed batch feeds the ``infer`` utilization gauge with its estimated
cost (``observability.profiling.program_cost``, once per signature) and
its host interval (the batch's fetches are copied to the host, so the
host has waited for the card); completions feed the priority-class
families.
"""
import json
import os
import threading
import time

import numpy as np

from .. import profiler as _prof
from ..flags import flag
from ..observability import tracing as _trace
from ..observability import utilization as _util
from ..resilience import (CheckpointCorruptError, WatchdogTimeout,
                          WatchdogWorker, maybe_fail)
from .batching import BadRequestError, ServingError, next_bucket
from .cache import ExecutableCache, feed_signature
from .metrics import record_class_done

SIGNATURE_FILE = "_serving_signatures.json"


def load_param_snapshot(dirname, current):
    """New values of ``current``'s tensors (``{name: tensor}``) from a
    ``save_params``-layout checkpoint directory (one ``.npy`` a var and
    ``_manifest.json``), as CPU tensors: the hot-reload loader. Every
    file is checked against the manifest first, and each array must
    match its live tensor's shape and dtype: a corrupt or incomplete
    checkpoint raises :class:`CheckpointCorruptError`, a mismatch
    ``ValueError``, and nothing is returned."""
    from .. import io as fluid_io
    manifest = fluid_io._read_manifest(dirname)
    if manifest is None:
        raise CheckpointCorruptError(
            f"checkpoint dir {dirname!r} has no _manifest.json: "
            f"reload_weights only trusts manifest-verified checkpoints "
            f"(save with io.save_params / save_persistables)",
            path=dirname)
    meta = {"vars": {}}
    meta_path = os.path.join(dirname, fluid_io._META_FILE)
    if os.path.exists(meta_path):
        fluid_io._verify_against_manifest(dirname, fluid_io._META_FILE,
                                          manifest)
        with open(meta_path) as f:
            meta = json.load(f)
    out, missing = {}, []
    for name, cur in current.items():
        rel = fluid_io._escape(name) + ".npy"
        path = os.path.join(dirname, rel)
        if not os.path.exists(path):
            missing.append(name)
            continue
        fluid_io._verify_against_manifest(dirname, rel, manifest)
        try:
            arr = np.load(path, allow_pickle=False)
        except (OSError, ValueError) as e:
            raise CheckpointCorruptError(
                f"checkpoint file {rel!r} in {dirname!r} is unreadable: "
                f"{type(e).__name__}: {e}", path=path)
        tag = meta["vars"].get(name, {}).get("dtype", str(arr.dtype))
        t = fluid_io._restore(arr, tag, "cpu")
        if tuple(t.shape) != tuple(cur.shape) or t.dtype != cur.dtype:
            raise ValueError(
                f"checkpoint param {name!r} is {tuple(t.shape)}/{t.dtype}, "
                f"the serving snapshot holds {tuple(cur.shape)}/"
                f"{cur.dtype}: reload_weights only swaps like-for-like "
                f"weights")
        out[name] = t
    if missing:
        raise CheckpointCorruptError(
            f"checkpoint at {dirname!r} is missing {len(missing)} "
            f"serving parameter(s): {', '.join(sorted(missing))}; the old "
            f"snapshot was left untouched", path=dirname)
    return out


def copy_in_place(live, staged):
    """``live[n].copy_(staged[n])`` for every name of ``live``, after
    checking that ``staged`` holds each name at the same shape and dtype
    (a mismatch raises before any copy)."""
    import torch
    missing = sorted(n for n in live if n not in staged)
    if missing:
        raise ValueError(f"the weight snapshot is missing {missing}")
    for n, t in live.items():
        new = staged[n]
        if tuple(new.shape) != tuple(t.shape) or new.dtype != t.dtype:
            raise ValueError(f"weight {n!r} is {tuple(new.shape)}/"
                             f"{new.dtype}, the live one "
                             f"{tuple(t.shape)}/{t.dtype}")
    with torch.no_grad():
        for n, t in live.items():
            t.copy_(staged[n])


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
        from ..utils.lru import LRUCache
        self._costs = LRUCache(max_entries=256)
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
        maybe_fail("serving.compile")
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
        else:
            _prof.record_duration("serving/compile", dt)
        return entry

    def entry_for(self, feed):
        """The cached entry of ``feed``'s signature, captured on a miss."""
        return self._entry_timed(feed)[0]

    def _entry_timed(self, feed):
        """(entry, capture seconds or None on a cache hit)."""
        with self._lock:
            entry = self.cache.get(feed_signature(feed))
            if entry is not None:
                return entry, None
            t0 = time.perf_counter()
            entry = self._compile(feed)
            return entry, time.perf_counter() - t0

    def _cost(self, feed):
        """The estimated cost of one execution at ``feed``'s signature
        (False: nothing to count), memoized."""
        from ..observability.profiling import program_cost
        try:
            return _util.cost_for(
                self._costs, feed_signature(feed), lambda: program_cost(
                    self._optimized,
                    {n: tuple(a.shape) for n, a in feed.items()}))
        except Exception:  # noqa: BLE001 — telemetry never kills a batch
            return False

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
        maybe_fail("serving.execute")
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
        t_pad = time.perf_counter() - t0
        if self.stats:
            self.stats.hist["pad"].observe(t_pad)
        traced = [r for r in live if r.trace is not None]
        for req in traced:
            _trace.record_child("serving/pad", t0, t0 + t_pad, req.trace)
        cost = self._cost(feed)
        with self._lock:
            entry, compile_s = self._entry_timed(feed)
            t1 = time.perf_counter()
            outs = entry.run(feed)
            t_exec = time.perf_counter() - t1
        if compile_s is not None:
            for req in traced:
                _trace.record_child("serving/compile", t1 - compile_s, t1,
                                    req.trace)
        for req in traced:
            _trace.record_child("serving/execute", t1, t1 + t_exec,
                                req.trace)
        if cost:
            _util.observe_execution("infer", cost, t_exec)
        if self.stats:
            self.stats.hist["execute"].observe(t_exec)
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
        record_class_done(req.priority, time.monotonic() - req.t_enqueue)
        if self.stats:
            self.stats.bump("requests_completed")
            self.stats.hist["total"].observe(
                time.monotonic() - req.t_enqueue)

    def state_tensors(self):
        """``{name: tensor}`` of the scope state the optimized program
        reads: what every captured program holds the addresses of."""
        from ..framework.lowering import analyze_block_io
        reads, _ = analyze_block_io(self._optimized, 0, self.feed_names)
        out = {}
        for n in sorted(reads):
            val = self.scope.find_var(n)
            if hasattr(val, "copy_"):
                out[n] = val
        return out

    def load_state_snapshot(self, dirname):
        """Verified new values of every model state tensor from a
        manifest-carrying checkpoint directory, staged on the device.
        Raises (``CheckpointCorruptError``, ``ValueError``) with the live
        weights untouched; the result is for :meth:`swap_state`."""
        host = load_param_snapshot(dirname, self.state_tensors())
        return {n: t.to(self.device) for n, t in host.items()}

    def swap_state(self, new_state):
        """Copy a staged snapshot into the live state tensors in place,
        between micro-batches (under the engine's lock: a batch in flight
        finishes on the old weights, every later replay reads the
        new)."""
        with self._lock:
            copy_in_place(self.state_tensors(), new_state)

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
    """Slot-batched decoding over a ``models.generation.GPTGenerator``: a
    fixed bank of ``slots`` generation rows over a dense bank (one
    ``[slots, H, max_len, D]`` cache per layer) or, with ``paged=True``,
    a shared ``KVBlockPool`` (``kv_dtype``, ``kv_block_size``,
    ``kv_pool_blocks``, ``pool_name``; ``prefix_cache`` None ->
    ``FLAGS_kv_prefix_cache``). Every decode step is a replay of the
    engine's own ``CapturedDecode`` graph (``decoder``; its generator,
    seeded from ``seed``, draws every sample of the bank). The
    ``DecodeBatcher`` thread is its only caller:

    - ``admit(requests, slot_ids)``: bucketed prefill over the new
      prompts, their first tokens, their keys/values into their slots
      (and the prefix index);
    - ``start_prefill``/``prefill_chunk``/``finish_prefill``: chunked
      admission (``FLAGS_prefill_chunk_tokens``, or the prefix cache),
      one chunk per decode round, after adopting a cached prefix;
    - ``admit_imported``: migrated KV blocks in place of a prefill;
      ``export_slot``: a slot's blocks out (paged only);
    - ``prepare_step(active_pos, widths)``: allocation-on-append and the
      copy-on-write barrier before a step; returns the rows the pool
      could not grow;
    - ``step``: one decode + sample over the whole bank; ``spec_step``:
      one speculative verify + acceptance (paged only);
    - ``release_slot``/``reclaim_leaks``: blocks back to the pool;
    - ``reset``: a restarted loop's empty bank (every block freed, the
      device pool and the decode graphs released);
    - ``load_param_snapshot``/``stage_params`` off the loop, then
      ``apply_params`` between steps: the hot reload.
    """

    def __init__(self, generator, *, slots=None, stats=None, seed=0,
                 paged=None, kv_dtype=None, kv_block_size=None,
                 kv_pool_blocks=None, pool_name="serving",
                 prefix_cache=None):
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
                max_seq_len=self.max_len, block_size=kv_block_size,
                num_blocks=kv_pool_blocks, dtype=kv_dtype, name=pool_name,
                prefix_cache=prefix_cache, device=generator.device)
        self._seed = int(seed)
        self.decoder = generator.new_decoder(seed)
        self._rng = self.decoder.generator
        self.bank_lost = False          # see _drop_bank
        self._bank_epoch = 0
        self._worker = WatchdogWorker("serving-decode-step")
        # (abandoned worker, released arrays) until that worker ends
        self._deposed = []

    def _kv(self):
        if self.pool is not None:
            return self.pool
        if self._caches is None:
            self._caches = self.gen.new_dense_caches(self.slots)
        return self._caches

    def _bank(self):
        """The bank as one step sees it: a view of the pool fixed when
        the step is handed out (``KVBlockPool.view``), or the dense
        bank's tensors."""
        return self.pool.view() if self.pool is not None else self._kv()

    def stop_worker(self):
        """Let the decode steps' worker thread exit (the decode loop
        stopped); a later step starts a fresh one."""
        self._worker.close()

    def _release_bank(self):
        """Release the bank's device memory and the decode graphs over
        it. The decoder is replaced, not cleared: a step abandoned by the
        watchdog may still hold the old one's lock, and it steps over its
        own view of the old arrays, so whatever it writes late lands
        there."""
        self._bank_epoch += 1
        self._caches = None
        self.decoder = self.gen.new_decoder(self._seed)
        self._rng = self.decoder.generator

    def _drop_bank(self, worker=None):
        """After a watchdog trip the step's ``worker`` thread may still
        run: release the bank (the pool's device arrays; its host block
        accounting stays, and the failed rows return their blocks as
        they finish) and flag the loss, so the batcher fails every row
        whose keys and values were in it. The released arrays stay
        referenced until ``worker`` ends, so the allocator cannot hand
        their memory to the bank built next while a late write may still
        land in it."""
        released = (self.pool.drop_device() if self.pool is not None
                    else None, self._caches)
        if worker is not None and worker.is_alive():
            self._deposed.append((worker, released))
        self._release_bank()
        self.bank_lost = True

    def reset(self):
        """Forget the bank without flagging a loss: a restarted decode
        loop starts from an empty one (its rows were already failed).
        Every block of the pool is freed too."""
        if self.pool is not None:
            self.pool.reset()
        self._release_bank()
        self.bank_lost = False

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

    def prepare_step(self, active_pos, widths=None):
        """Before a step: grow each live row's blocks to cover the slots
        it writes (``active_pos``: slot -> position; ``widths``: slot ->
        tokens written, default 1, a speculative span's K+1) and, with
        the prefix cache, copy any shared block in that span first (even
        for draft positions later rejected). Returns ``{slot: exc}`` for
        rows the pool could not serve; dense: {}."""
        if self.pool is None:
            return {}
        shed = {}
        for slot, p in active_pos.items():
            w = max(int(widths.get(slot, 1)) if widths else 1, 1)
            try:
                self.pool.ensure(slot, int(p) + w - 1)
                if self.pool.prefix_enabled:
                    self.pool.prepare_write(slot, int(p), int(p) + w)
            except Exception as exc:  # noqa: BLE001 — per-row shed
                shed[slot] = exc
        return shed

    def reclaim_leaks(self, live_slots):
        """The leak sweep: free blocks held by slots not in
        ``live_slots``; returns the blocks freed (dense: 0)."""
        if self.pool is None:
            return 0
        return self.pool.reclaim_leaks(live_slots)

    def admit(self, requests, slot_ids):
        """Prefill the requests' prompts as one bucketed batch, sample
        their first tokens, write their keys/values into ``slot_ids``
        (and, with the prefix cache, their blocks into the index).
        Returns the first tokens, np.int32 ``[len(requests)]``."""
        maybe_fail("serving.prefill")
        self.bank_lost = False
        t0 = time.perf_counter()
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
            maybe_fail("serving.slot_insert")
            if self.pool is not None:
                self.pool.scatter_prefill(list(slot_ids), ks, vs, s)
            else:
                cache_k, cache_v = self._kv()
                for c, new in zip(cache_k + cache_v, ks + vs):
                    c[list(slot_ids), :, :s] = new[:n]
        except Exception:
            for sl in slot_ids:
                self.release_slot(sl)
            raise
        if self.pool is not None:
            for req, slot in zip(requests, slot_ids):
                self.pool.prefix_insert(req.prompt, slot)
        t1 = time.perf_counter()
        for req in requests:
            if req.trace is not None:
                _trace.record_child("serving/prefill", t0, t1, req.trace)
        return toks[:n]

    # -- chunked (incremental) prefill ------------------------------------
    def incremental_prefill_enabled(self):
        """Chunked admission: on with the paged pool and either
        ``FLAGS_prefill_chunk_tokens`` > 0 (long prompts stop stalling
        the bank) or the prefix cache (what turns a cached-prefix hit
        into skipped prefill)."""
        return self.pool is not None and (
            int(flag("prefill_chunk_tokens")) > 0 or self.pool.prefix_enabled)

    def start_prefill(self, req, slot):
        """Begin chunked prefill of ``req`` into ``slot``: free the stale
        holder, adopt the longest cached prefix (block references, no
        compute), and return the state :meth:`prefill_chunk` advances. A
        full exact-prompt hit still replays the last token as a 1-token
        chunk: its logits are the first token's distribution."""
        prompt = np.asarray(req.prompt, np.int32).reshape(-1)
        L = int(prompt.size)
        self.bank_lost = False
        self.pool.free_slot(slot)
        reused = 0
        m = self.pool.match_prefix(prompt)
        if m is not None:
            self.pool.adopt_prefix(slot, m)
            reused = int(m["tokens"])
        return {"req": req, "slot": int(slot), "prompt": prompt,
                "next": min(reused, L - 1), "reused": reused,
                "chunk": int(flag("prefill_chunk_tokens")),
                "first_logits": None, "t0": time.perf_counter()}

    def prefill_chunk(self, state):
        """Ingest ONE chunk of ``state``'s prompt into its slot (at most
        the chunk budget; the whole rest without one). Pool pressure
        (alloc, copy-on-write) raises before any device work. Returns
        True once the prompt is in (sample via :meth:`finish_prefill`)."""
        slot, prompt = state["slot"], state["prompt"]
        L = int(prompt.size)
        s = int(state["next"])
        take = min(state["chunk"] or (L - s), L - s)
        # a fixed width under a budget, else a bucketed one
        C = state["chunk"] or min(
            next_bucket(take, min_bucket=self.gen.bucket_min), self.max_len)
        toks = np.zeros((1, C), np.int32)
        toks[0, :take] = prompt[s:s + take]
        pos_ids = np.clip(np.arange(s, s + C, dtype=np.int32), 0,
                          L - 1)[None, :]
        self.pool.alloc(slot, s + take)
        if self.pool.prefix_enabled:
            self.pool.prepare_write(slot, s, s + take)
        logits = self.gen.run_prefill_chunk(
            toks, pos_ids, np.array([s], np.int32),
            np.array([take], np.int32), np.array([take - 1], np.int32),
            self.pool, rows=[slot])
        state["next"] = s + take
        if state["next"] >= L:
            state["first_logits"] = logits[:1]
            return True
        return False

    def finish_prefill(self, state):
        """Sample the first token from the last chunk's logits, put the
        prompt's blocks into the prefix index, return the token (int)."""
        req = state["req"]
        toks = self.gen.run_sample(
            state["first_logits"], np.array([req.temperature], np.float32),
            np.array([req.top_k], np.int32), self._rng)
        self.pool.prefix_insert(state["prompt"], state["slot"])
        if req.trace is not None:
            _trace.record_child("serving/prefill_chunked", state["t0"],
                                time.perf_counter(), req.trace)
        return int(toks[0])

    # -- disaggregated prefill / decode (KV migration) --------------------
    def export_slot(self, slot):
        """``slot``'s KV blocks as a migration payload (paged only: the
        block table is what makes a row's state a movable unit)."""
        if self.pool is None:
            raise BadRequestError(
                "KV export requires the paged pool (FLAGS_kv_paged / "
                "paged=True) — the dense bank's rows are not migratable")
        return self.pool.export_slot(slot)

    def admit_imported(self, requests, slot_ids):
        """Admit requests whose prefill ran elsewhere: each request's
        ``kv`` payload goes into its slot's blocks in place of a prefill.
        Returns their ``first_token`` s (sampled where the prefill ran),
        np.int32; on failure nothing stays allocated."""
        if self.pool is None:
            raise BadRequestError(
                "KV import requires the paged pool (FLAGS_kv_paged / "
                "paged=True) on the decode side")
        t0 = time.perf_counter()
        imported = []
        try:
            for req, slot in zip(requests, slot_ids):
                self.pool.free_slot(slot)
                self.pool.import_slot(slot, req.kv)
                imported.append(slot)
        except Exception:
            for sl in imported:
                self.pool.free_slot(sl)
            raise
        t1 = time.perf_counter()
        first = np.asarray([int(req.first_token) for req in requests],
                           np.int32)
        for req in requests:
            if req.trace is not None:
                _trace.record_child("serving/kv_import", t0, t1, req.trace)
            req.kv = None               # the pool holds the blocks now
        return first

    # -- hot weight reload ------------------------------------------------
    def load_param_snapshot(self, dirname):
        """Verified new host values (CPU tensors) of every generator
        parameter; raises with the live weights untouched."""
        return load_param_snapshot(dirname, self.gen.param_tensors())

    def stage_params(self, host_params):
        """The verified values on the device, off the decode loop, so the
        swap itself is device copies only."""
        return {n: t.to(self.gen.device) for n, t in host_params.items()}

    def apply_params(self, device_params):
        """The swap: the staged values copied into the model's tensors in
        place (``GPTGenerator.swap_params``). Run on the decode loop
        between steps (``DecodeBatcher.request_swap``), so rows in
        flight finish on the old weights."""
        self.gen.swap_params(device_params)

    # -- steps ------------------------------------------------------------
    def _watched(self, fn, budget, what):
        """``fn`` (the step) under the watchdog: the fault point
        ``serving.decode_step`` fires first, on the worker, before the
        decode graph's lock; a step reached after the bank was released
        does not run. A trip releases the bank and raises
        ``WatchdogTimeout``."""
        bank = self._bank_epoch
        if self._deposed:
            self._deposed = [d for d in self._deposed if d[0].is_alive()]

        def _work():
            maybe_fail("serving.decode_step")
            if self._bank_epoch != bank:
                raise ServingError("the decode bank was released while "
                                   "this step waited; it does not run")
            return fn()

        if not budget:
            return _work()
        try:
            return self._worker.call(_work, budget, what=what)
        except WatchdogTimeout as exc:
            self._drop_bank(getattr(exc, "thread", None))
            raise

    def step(self, tokens, pos, temperature, top_k, live=None, budget=None):
        """One decode + sample over the whole bank (a graph replay on the
        GPU). Arrays of length ``slots``; ``live`` (bool ``[slots]``,
        None: all) marks the decoding slots. The others carry stale
        values whose tokens nobody reads; in the pool their writes go to
        the trash block, since a slot mid chunked prefill already owns
        the blocks its stale position points into (the dense bank's
        rows are overwritten by their next prefill). ``budget``: the
        watchdog's seconds (None: no watchdog). Returns np.int32 tokens
        ``[slots]``."""
        self.bank_lost = False
        args = (np.ascontiguousarray(tokens, dtype=np.int32),
                np.ascontiguousarray(pos, dtype=np.int32),
                np.ascontiguousarray(temperature, dtype=np.float32),
                np.ascontiguousarray(top_k, dtype=np.int32), self._bank())
        decoder = self.decoder
        return self._watched(
            lambda: self.gen.decode(*args, decoder=decoder, live=live),
            budget, "serving decode step")

    def spec_step(self, tokens, pos, temperature, top_k, drafts, num_draft,
                  live, budget=None):
        """One speculative verify + acceptance over the whole bank (paged
        only). ``drafts`` np int32 ``[slots, K]``, ``num_draft [slots]``
        the real drafts a row (0: a plain one-token step in the same
        pass), ``live`` the occupied slots (the others' span writes go to
        the trash block). Returns ``(out [slots, K+1], accepted
        [slots])``: slot s emits ``out[s, :accepted[s] + 1]``."""
        if self.pool is None:
            raise ValueError("speculative decoding requires the paged KV "
                             "pool (FLAGS_kv_paged / paged=True)")
        self.bank_lost = False
        bank, rng = self._bank(), self._rng
        return self._watched(
            lambda: self._spec_step(tokens, pos, temperature, top_k,
                                    drafts, num_draft, live, bank, rng),
            budget, "serving spec verify step")

    def _spec_step(self, tokens, pos, temperature, top_k, drafts,
                   num_draft, live, bank, rng):
        tok = np.ascontiguousarray(tokens, dtype=np.int32)
        posc = np.ascontiguousarray(pos, dtype=np.int32)
        drafts = np.ascontiguousarray(drafts, dtype=np.int32)
        nd = np.ascontiguousarray(num_draft, dtype=np.int32)
        S = drafts.shape[1] + 1
        span = np.clip(posc[:, None] + np.arange(S, dtype=np.int32)[None, :],
                       0, self.gen.cfg.max_position - 1)
        limit = np.where(np.asarray(live, bool), nd + 1, 0).astype(np.int32)
        logits = self.gen.run_verify_paged(
            np.concatenate([tok[:, None], drafts], axis=1), span, posc, limit,
            bank)
        return self.gen.run_spec_accept(logits, drafts, temperature, top_k,
                                        nd, rng)
