"""Autoregressive generation over the KV-cached GPT: one bucketed
prefill over the prompts, then one decode step per token.

Counterpart of ``paddle_tpu/models/generation.py`` (``GPTGenerator``, the
drafters). The same power-of-two prompt packing (``_pack_prompts``), the
same emission rule (``_emit``) and the same decode loops: the dense bank
(a ``[B, H, max_len, D]`` cache per layer) and the block-paged pool
(``serving.kvpool.KVBlockPool``), each optionally speculative
(``spec_k``: a drafter proposes up to K tokens a row, one verify pass
scores all K+1 positions, rejection sampling keeps the agreed prefix;
greedy output is the non-speculative output). Sampling is per row
(greedy where temperature <= 0, else temperature/top-k) and draws from
the generator of the decoder, seeded from ``seed``; greedy output does
not depend on it.

Every decode step runs through a ``framework.cuda_graph.CapturedDecode``:
on the GPU a replayed CUDA graph per signature (the JAX package compiles
the step once per signature and caches the executable). The pool and
dense bank ``generate`` decodes over are kept between calls, so their
graphs stay valid; :meth:`GPTGenerator.release` frees them. The verify
and chunked-prefill steps run eagerly. ``generate_naive`` recomputes the
whole forward for every token (the reference of the KV-cached path).

Telemetry: every prefill, decode and verify step is attached to its cost
(``observability.utilization.gpt_step_cost``) for the ``prefill`` and
``decode`` utilization gauges: a decode step by its host interval (the
step reads its tokens back, so the host has waited for the card), a
prefill by a pair of CUDA events read once complete. Stage times go to
the ``stats`` sink when one is attached, else to the profiler as
``decode/<stage>`` while it is active, and a decode graph's capture as
``decode/compile_<kind>``.

    gen = GPTGenerator(cfg, params, max_len=512)           # on the GPU
    outs = gen.generate([prompt_ids], max_new_tokens=64, paged=True)
"""
import contextlib
import time

import numpy as np
import torch

from .. import profiler as _prof
from ..device import resolve_device
from ..flags import flag
from ..observability import utilization as _util
from ..ops.decode_ops import all_greedy, sample_tokens, spec_accept
from ..serving.batching import next_bucket
from .gpt import GPT


def length_bucket(n, lo=1):
    """Smallest power-of-two >= n (>= lo): the prefill length and batch
    buckets, shared with the serving batcher."""
    return next_bucket(n, min_bucket=lo)


# -- drafters ----------------------------------------------------------
# A drafter proposes up to k continuation tokens for one row's context:
# draft(ctx_tokens, k) -> 1-D int array of <= k proposals.

class NgramDrafter:
    """Prompt-lookup drafter: the tokens that followed the most recent
    earlier occurrence of the context's trailing n-gram. No model, no
    device work; strong when the output echoes its context."""

    def __init__(self, max_ngram=3):
        self.max_ngram = int(max_ngram)

    def draft(self, ctx, k):
        ctx = np.asarray(ctx, np.int32).ravel()
        n = int(ctx.size)
        k = int(k)
        if k <= 0 or n < 2:
            return np.zeros((0,), np.int32)
        for ng in range(min(self.max_ngram, n - 1), 0, -1):
            pat = ctx[n - ng:]
            # windows strictly before the trailing n-gram itself
            wins = np.lib.stride_tricks.sliding_window_view(
                ctx[:n - 1], ng)[:n - ng]
            hits = np.flatnonzero(np.all(wins == pat, axis=1))
            if hits.size:
                # the most recent hit with a full k-token continuation,
                # else the most recent one (a cycling context's nearest
                # hit sits one period back)
                full = hits[hits + ng + k <= n]
                i = int(full[-1]) if full.size else int(hits[-1])
                cont = ctx[i + ng:i + ng + k]
                if 0 < cont.size < k:
                    # ran off the end of the context: extend it
                    # periodically (a wrong guess is merely rejected)
                    cont = np.resize(cont, k)
                if cont.size:
                    return cont.astype(np.int32)
        return np.zeros((0,), np.int32)


class ModelDrafter:
    """Greedy continuations of a (small) :class:`GPTGenerator`.
    :meth:`from_generator` builds the first layers of the target model
    over the SAME parameter tensors, so drafting needs no second
    checkpoint."""

    def __init__(self, draft_gen):
        self.gen = draft_gen

    @classmethod
    def from_generator(cls, gen, num_layers=1):
        model = gen.model.truncated(num_layers)
        return cls(GPTGenerator(model.cfg, model, max_len=gen.max_len,
                                bucket_min=gen.bucket_min,
                                device=gen.device))

    def draft(self, ctx, k):
        ctx = np.asarray(ctx, np.int32).ravel()
        k = int(k)
        lim = self.gen.max_len - k
        if k <= 0 or lim < 1:
            return np.zeros((0,), np.int32)
        out = self.gen.generate([ctx[-lim:]], max_new_tokens=k,
                                temperature=0.0, paged=False, spec_k=0)
        return np.asarray(out[0], np.int32)


def make_drafter(mode=None, generator=None):
    """Drafter for ``FLAGS_decode_spec_mode``: ``"ngram"`` (default) or
    ``"model"`` (a 1-layer draft GPT over ``generator``'s parameters)."""
    mode = mode or flag("decode_spec_mode") or "ngram"
    if mode == "ngram":
        return NgramDrafter()
    if mode == "model":
        if generator is None:
            raise ValueError("decode_spec_mode='model' needs the target "
                             "generator to share parameters with")
        return ModelDrafter.from_generator(generator)
    raise ValueError(f"unknown decode_spec_mode {mode!r} — 'ngram' or "
                     f"'model'")


class GPTGenerator:
    """Prefill + decode + sampler over one GPT's parameters.

    ``params`` is ``{JAX scope name: array}`` (or a built :class:`GPT`);
    ``device=None`` means the GPU and raises without one — tests pass
    ``device="cpu"``. ``stats`` (a ``serving.ServingStats``) receives the
    prefill/decode/sample stage latencies; with a sink attached each
    stage synchronizes the device before it is timed."""

    def __init__(self, cfg, params, *, max_len=None, bucket_min=None,
                 device=None, stats=None):
        self.cfg = cfg
        self.device = resolve_device(device)
        self.model = params if isinstance(params, GPT) \
            else GPT(cfg, params, device=self.device)
        self.max_len = min(int(max_len or flag("decode_max_len")),
                           int(cfg.max_position))
        self.bucket_min = int(bucket_min or flag("decode_bucket_min"))
        self.stats = stats
        # kept between generate() calls, so their decode graphs stay
        # valid: (rows, kv dtype, block size) -> KVBlockPool (blocks are
        # freed after every call) and rows -> dense bank
        self._paged_pools = {}
        self._banks = {}
        self._drafters = {}
        self._decoder = None
        self._timer = _util.ExecutionTimer()

    @property
    def decoder(self):
        """The :class:`~paddle_tpu_torch.framework.cuda_graph.CapturedDecode`
        of ``generate``'s decode steps."""
        if self._decoder is None:
            self._decoder = self.new_decoder()
        return self._decoder

    def new_decoder(self, seed=0):
        """A decode-step graph cache over this model (the serving engine
        keeps its own)."""
        from .. import kernels
        from ..framework.cuda_graph import CapturedDecode
        return CapturedDecode(self.model, self.device, seed=seed,
                              counters=kernels.COUNTED)

    def param_tensors(self):
        """``{JAX scope name: tensor}`` of the model's parameters: the
        tensors every decode graph and prefill reads."""
        from .gpt import param_shapes
        return {n: self.model.param(n) for n in param_shapes(self.cfg)}

    def swap_params(self, new_params):
        """Hot weight swap: ``new_params`` (``{name: tensor}`` on this
        device, every parameter at its shape and dtype; a mismatch raises
        before any copy) copied into the model's tensors in place. The
        JAX package rebinds its parameter snapshot; here the captured
        decode graphs read these tensors at fixed addresses, so the copy
        is what makes every later prefill, step and replay use the new
        weights. The copies are ordered on the device after the work
        already issued (a step in flight finishes on the old weights)."""
        from ..serving.engine import copy_in_place
        copy_in_place(self.param_tensors(), new_params)

    def release(self):
        """Free what ``generate`` keeps between calls: its dense bank's
        and its pool's device memory and the decode graphs over them."""
        if self._decoder is not None:
            self._decoder.clear()
        for pool in self._paged_pools.values():
            pool.reset()
        self._paged_pools.clear()
        self._banks.clear()
        for d in self._drafters.values():
            if isinstance(d, ModelDrafter):
                d.gen.release()
        self._drafters.clear()

    # -- stage runners ----------------------------------------------------
    @contextlib.contextmanager
    def _stage(self, stage, cost=None, synced=False):
        """Times one stage. ``cost``: the step's ``{"flops", "bytes"}``
        for the ``stage`` utilization gauge, timed by the host interval
        when the body ends with the host waiting for the card
        (``synced``), else by a CUDA event pair read once complete. The
        stage's time goes to the stats sink (synchronizing first), or to
        the profiler while it is active. The body may put host seconds
        that were no execution (a graph capture) into the yielded dict's
        ``"excluded"``: a synced stage leaves them out of both times, as
        the JAX package leaves compile time out."""
        timed = self.stats is not None or _prof.is_profiling()
        start = self._timer.begin(self.device) \
            if cost and not synced else None
        t0 = time.perf_counter()
        body = {"excluded": 0.0}
        yield body
        if cost and synced:
            _util.observe_execution(
                stage, cost, time.perf_counter() - t0 - body["excluded"])
        if start is not None:
            self._timer.end(start, (stage, cost))
        if timed:
            if self.device.type == "cuda":
                torch.cuda.synchronize(self.device)
            dt = time.perf_counter() - t0 - body["excluded"]
            if self.stats is not None:
                self.stats.hist[stage].observe(dt)
            else:
                _prof.record_duration(f"decode/{stage}", dt)
        for seconds, (where, c) in self._timer.poll():
            _util.observe_execution(where, c, seconds)

    def _step_cost(self, ctx_lens, new_tokens=1, logits_per_row=1, kv=None):
        """:func:`~paddle_tpu_torch.observability.utilization.gpt_step_cost`
        of this model over ``kv`` (a pool prices its element type)."""
        kv_bytes = {"fp32": 4, "bf16": 2, "int8": 1}.get(
            getattr(kv, "dtype", "fp32"), 4)
        return _util.gpt_step_cost(
            self.cfg, ctx_lens, new_tokens=new_tokens,
            logits_per_row=logits_per_row, kv_itemsize=kv_bytes,
            param_itemsize=self.model.param("word_embedding").element_size())

    def _dev(self, a, dtype=torch.int64):
        return torch.as_tensor(np.asarray(a)).to(self.device, dtype)

    def new_dense_caches(self, rows):
        """Zeroed dense bank: per layer ``[rows, H, max_len, D]`` K and V."""
        shape = (rows, self.cfg.num_heads, self.max_len, self.cfg.d_head)
        n = self.cfg.num_layers
        return ([torch.zeros(shape, device=self.device) for _ in range(n)],
                [torch.zeros(shape, device=self.device) for _ in range(n)])

    def run_prefill(self, tokens, pos_ids, last_pos):
        """Packed prompts (numpy) -> ``(logits, ks, vs)`` on the device."""
        bb, s = np.shape(tokens)
        with self._stage("prefill", self._step_cost(np.zeros(bb), s)):
            return self.model.prefill(self._dev(tokens), self._dev(pos_ids),
                                      self._dev(last_pos))

    def run_logits(self, tokens, pos_ids, last_pos):
        """The full forward without a cache (``gpt_logits``): logits
        ``[B, V]`` at each row's ``last_pos``."""
        bb, s = np.shape(tokens)
        with self._stage("prefill", self._step_cost(np.zeros(bb), s)):
            return self.model.logits(self._dev(tokens), self._dev(pos_ids),
                                     self._dev(last_pos))

    def decode(self, token, pos, temperature, top_k, kv, decoder=None,
               live=None):
        """One decode step and its sample over ``kv`` (a dense bank
        ``(cache_k, cache_v)`` or a ``KVBlockPool``) through ``decoder``
        (default :attr:`decoder`): np.int32 tokens. ``live`` (bool per
        row, None: all) limits a pool's writes to those rows' blocks."""
        decoder = decoder or self.decoder
        captures, capture_s = decoder.captures, decoder.capture_s
        with self._stage("decode", self._step_cost(pos, 1, kv=kv),
                         synced=True) as body:
            toks = decoder.run(token, pos, temperature, top_k, kv,
                               live=live)
            body["excluded"] = decoder.capture_s - capture_s
        if decoder.captures != captures:
            kind = "decode" if isinstance(kv, tuple) else "decode_paged"
            _prof.record_duration(f"decode/compile_{kind}", body["excluded"])
            if self.stats is not None:
                self.stats.bump("compiles")
                self.stats.hist["compile"].observe(body["excluded"])
        return toks

    def _decode_logits(self, token, pos, kv):
        rows = int(np.shape(token)[0])
        self.decode(token, pos, np.zeros(rows, np.float32),
                    np.zeros(rows, np.int32), kv)
        return self.decoder.logits.clone()

    def run_decode(self, token, pos, cache_k, cache_v):
        """One decode step over the dense bank (a graph replay on the
        GPU): logits ``[B, V]`` on the device."""
        return self._decode_logits(token, pos, (cache_k, cache_v))

    def run_decode_paged(self, token, pos, pool):
        """One decode step over the block pool (a graph replay on the
        GPU): logits ``[B, V]`` on the device."""
        return self._decode_logits(token, pos, pool)

    def run_prefill_chunk(self, tokens, pos_ids, start_pos, limit, last_idx,
                          pool, rows=None):
        """One chunk of incremental paged prefill into ``pool``; ``rows``
        picks the pool slots whose tables line up with the token rows
        (None: every slot). Logits ``[B, V]`` at ``last_idx``."""
        tables = pool.device_tables(rows)
        cost = self._step_cost(start_pos, np.shape(tokens)[1], kv=pool)
        with self._stage("prefill", cost):
            return self.model.prefill_chunk_paged(
                self._dev(tokens), self._dev(pos_ids), self._dev(start_pos),
                self._dev(limit), self._dev(last_idx), tables, pool.layers())

    def run_verify(self, tokens, pos, pos_ids, cache_k, cache_v):
        """One speculative verify step over the dense bank: span logits
        ``[B, S, V]``."""
        S = np.shape(tokens)[1]
        with self._stage("decode", self._step_cost(pos, S, S)):
            return self.model.verify_step(self._dev(tokens), self._dev(pos),
                                          self._dev(pos_ids), cache_k,
                                          cache_v)

    def run_verify_paged(self, tokens, pos_ids, start_pos, limit, pool,
                         rows=None):
        """One speculative verify step over the block pool (``limit``: each
        row's real span): span logits ``[B, S, V]``."""
        tables = pool.device_tables(rows)
        S = np.shape(tokens)[1]
        with self._stage("decode",
                         self._step_cost(start_pos, S, S, kv=pool)):
            return self.model.verify_step_paged(
                self._dev(tokens), self._dev(pos_ids), self._dev(start_pos),
                self._dev(limit), tables, pool.layers())

    def run_spec_accept(self, logits, draft, temperature, top_k, num_draft,
                        generator=None):
        """Rejection-sampling acceptance over a verified span: np
        ``(tokens [B, S], accepted [B])``; row b emits
        ``tokens[b, :accepted[b] + 1]``."""
        topk = np.asarray(top_k)
        with self._stage("sample"):
            out, acc = spec_accept(
                logits, self._dev(draft), torch.as_tensor(
                    np.asarray(temperature, np.float32)),
                self._dev(num_draft),
                top_k=torch.as_tensor(topk) if (topk > 0).any() else None,
                generator=generator or self.decoder.generator)
            return out.cpu().numpy(), acc.cpu().numpy()

    def run_sample(self, logits, temperature, top_k, generator=None):
        """Logits on the device -> np.int32 tokens on the host (the
        prefill's first token; decode steps sample inside their graph)."""
        with self._stage("sample"):
            topk = np.asarray(top_k)
            toks = sample_tokens(
                logits, torch.as_tensor(np.asarray(temperature, np.float32)),
                torch.as_tensor(topk) if (topk > 0).any() else None,
                generator=generator or self.decoder.generator,
                greedy=all_greedy(temperature))
            return toks.cpu().numpy()

    # -- public API -------------------------------------------------------
    def _prep(self, prompts, max_new_tokens):
        # a bare 1-D array / flat list of ints is ONE prompt
        if isinstance(prompts, np.ndarray):
            prompts = [prompts] if prompts.ndim <= 1 else list(prompts)
        elif isinstance(prompts, (list, tuple)) and prompts \
                and np.isscalar(prompts[0]):
            prompts = [np.asarray(prompts)]
        prompts = [np.asarray(p).ravel().astype(np.int32) for p in prompts]
        if not prompts:
            raise ValueError("generate() needs at least one prompt")
        lens = [int(p.size) for p in prompts]
        if min(lens) < 1:
            raise ValueError("empty prompt")
        if max(lens) + int(max_new_tokens) > self.max_len:
            raise ValueError(
                f"prompt len {max(lens)} + max_new_tokens {max_new_tokens} "
                f"exceeds the generator's max_len {self.max_len} (raise "
                f"max_len= or FLAGS_decode_max_len)")
        return prompts, lens

    def _pack_prompts(self, prompts):
        """Right-pad 1-D int32 prompts into the bucketed prefill feed:
        ``(tokens [bb, s], pos_ids [bb, s], last_pos [bb])`` — shared by
        generate(), generate_naive() and the serving engine."""
        lens = [int(p.size) for p in prompts]
        bb = length_bucket(len(prompts))
        s = min(length_bucket(max(lens), self.bucket_min), self.max_len)
        tokens = np.zeros((bb, s), np.int32)
        for r, p in enumerate(prompts):
            tokens[r, :p.size] = p
        pos_ids = np.broadcast_to(np.arange(s, dtype=np.int32),
                                  (bb, s)).copy()
        last = np.zeros((bb,), np.int32)
        last[:len(prompts)] = np.asarray(lens, np.int32) - 1
        return tokens, pos_ids, last

    @staticmethod
    def _emit(tok_h, outs, done, eos_id, max_new_tokens):
        for r in range(len(outs)):
            if done[r]:
                continue
            t = int(tok_h[r])
            if eos_id is not None and t == int(eos_id):
                done[r] = True
                continue
            outs[r].append(t)
            if len(outs[r]) >= max_new_tokens:
                done[r] = True

    def generate(self, prompts, max_new_tokens=32, temperature=0.0,
                 top_k=0, eos_id=None, seed=None, paged=None,
                 kv_dtype=None, spec_k=None, spec_mode=None, drafter=None):
        """KV-cached generation. ``prompts`` is a list of 1-D int token
        arrays (ragged lengths fine). Returns a list of 1-D int32 arrays
        of NEW tokens (generation stops at ``eos_id``, which is not
        included). ``paged`` (None -> ``FLAGS_kv_paged``) decodes over a
        block-paged pool instead of the dense bank, with ``kv_dtype``
        (None -> ``FLAGS_kv_cache_dtype``) as its element type; greedy
        output is the same either way. ``spec_k`` (None ->
        ``FLAGS_decode_spec_k``; 0 off) decodes speculatively with
        ``drafter`` (default: ``spec_mode``, None ->
        ``FLAGS_decode_spec_mode``); greedy output is the same.

        The decode storage outlives the call, since the captured decode
        graphs hold its addresses: one dense bank and one pool, each for
        the latest row bucket (and kv dtype, block size), are kept until
        :meth:`release` or until a call needs another. Each costs
        ``2 * num_layers * rows * max_len * hidden`` elements (float32:
        1.2 GB at GPT-base, 8 rows, max_len 2048; the pool by default one
        block more, bf16 half and int8 a quarter plus its scales), and a
        model drafter keeps its own pair for its layers."""
        if paged is None:
            paged = bool(flag("kv_paged"))
        if spec_k is None:
            spec_k = int(flag("decode_spec_k"))
        prompts, lens = self._prep(prompts, max_new_tokens)
        B = len(prompts)
        tokens, pos_ids, last = self._pack_prompts(prompts)
        bb, s = tokens.shape
        temp = np.full((bb,), float(temperature), np.float32)
        topk = np.full((bb,), int(top_k), np.int32)
        self.decoder.generator.manual_seed(0 if seed is None else int(seed))
        kv = self._pool(bb, kv_dtype) if paged else self._bank(bb)
        try:
            logits, ks, vs = self.run_prefill(tokens, pos_ids, last)
            if paged:
                for r in range(B):
                    kv.alloc(r, lens[r])
                kv.scatter_prefill(list(range(B)), ks, vs, s)
            else:
                for c, new in zip(kv[0] + kv[1], ks + vs):
                    c[:, :, :s] = new
            del ks, vs
            tok_h = self.run_sample(logits, temp, topk)
            outs = [[] for _ in range(B)]
            done = np.zeros(B, bool)
            # pos[r] = cache slot the NEXT fed token lands in
            pos = np.zeros((bb,), np.int32)
            pos[:B] = np.asarray(lens, np.int32)
            self._emit(tok_h, outs, done, eos_id, max_new_tokens)
            if int(spec_k) > 0:
                if drafter is None:
                    drafter = self._default_drafter(spec_mode)
                self._spec_loop(prompts, outs, done, tok_h, pos, temp, topk,
                                kv, int(spec_k), drafter, eos_id,
                                max_new_tokens)
            while not done.all():
                if paged:
                    for r in range(B):
                        if not done[r]:          # allocation-on-append
                            kv.ensure(r, int(pos[r]))
                tok_h = self.decode(tok_h, pos, temp, topk, kv)
                pos[:B] = np.where(done, pos[:B], pos[:B] + 1)
                self._emit(tok_h, outs, done, eos_id, max_new_tokens)
                if self.stats:
                    self.stats.bump("decode_steps")
            if self.stats:
                self.stats.bump("tokens_generated",
                                int(sum(len(o) for o in outs)))
            return [np.asarray(o, np.int32) for o in outs]
        finally:
            if paged:
                for r in range(bb):
                    kv.free_slot(r)

    def _default_drafter(self, mode):
        mode = mode or flag("decode_spec_mode") or "ngram"
        if mode not in self._drafters:
            self._drafters[mode] = make_drafter(mode, generator=self)
        return self._drafters[mode]

    def _spec_loop(self, prompts, outs, done, tok_h, pos, temp, topk, kv,
                   spec_k, drafter, eos_id, max_new_tokens):
        """The speculative steps of ``generate``: drafts capped to each
        row's remaining budget, one verify pass over all K+1 positions,
        rejection sampling. The dense bank takes plain decode steps where
        a span would run past the cache end (its fixed-span write cannot
        route to a trash block as the pool's ``limit`` does)."""
        B = len(prompts)
        bb = pos.shape[0]
        paged = not isinstance(kv, tuple)
        S = spec_k + 1
        while not done.all():
            draft = np.zeros((bb, spec_k), np.int32)
            nd = np.zeros((bb,), np.int32)
            for r in range(B):
                kr = min(spec_k, max_new_tokens - len(outs[r]) - 1)
                if done[r] or kr <= 0:
                    continue
                ctx = np.concatenate([prompts[r],
                                      np.asarray(outs[r], np.int32)])
                d = np.asarray(drafter.draft(ctx, kr), np.int32).ravel()[:kr]
                nd[r] = d.size
                draft[r, :d.size] = d
            if not paged and int(pos[:B][~done].max()) + S > self.max_len:
                return                  # the plain steps finish the rows
            feed = np.concatenate([tok_h[:, None], draft], axis=1)
            span_pos = np.clip(pos[:, None] + np.arange(S, dtype=np.int32),
                               0, self.cfg.max_position - 1)
            if paged:
                limit = np.zeros((bb,), np.int32)
                for r in range(B):
                    if not done[r]:
                        limit[r] = int(nd[r]) + 1
                        kv.alloc(r, int(pos[r]) + int(nd[r]) + 1)
                logits = self.run_verify_paged(feed, span_pos, pos, limit,
                                               kv)
            else:
                logits = self.run_verify(feed, pos, span_pos, kv[0], kv[1])
            out, acc = self.run_spec_accept(logits, draft, temp, topk, nd)
            for r in range(B):
                if done[r]:
                    continue
                a = int(acc[r])
                for j in range(a + 1):
                    t = int(out[r, j])
                    if eos_id is not None and t == int(eos_id):
                        done[r] = True
                        break
                    outs[r].append(t)
                    if len(outs[r]) >= max_new_tokens:
                        done[r] = True
                        break
                pos[r] += a + 1
                tok_h[r] = out[r, a]
            if self.stats:
                self.stats.bump("decode_steps")
                self.stats.bump("spec_steps")
                self.stats.bump("spec_drafted", int(nd.sum()))
                self.stats.bump("spec_accepted", int(acc[:B].sum()))
                self.stats.bump("spec_rejected", int(
                    ((acc[:B] < nd[:B]) & (nd[:B] > 0)).sum()))

    def generate_naive(self, prompts, max_new_tokens=32, temperature=0.0,
                       top_k=0, eos_id=None, seed=None):
        """Full recompute: every new token re-runs the whole forward
        (``run_logits``, flash attention) at the bucketed current length,
        no KV cache. Same bucketing and sampler as ``generate`` (greedy
        output is the same); the reference of the KV-cached path."""
        prompts, lens = self._prep(prompts, max_new_tokens)
        B = len(prompts)
        bb = length_bucket(B)
        cur = [list(map(int, p)) for p in prompts]
        outs = [[] for _ in range(B)]
        done = np.zeros(B, bool)
        temp = np.full((bb,), float(temperature), np.float32)
        topk = np.full((bb,), int(top_k), np.int32)
        self.decoder.generator.manual_seed(0 if seed is None else int(seed))
        while not done.all():
            tokens, pos_ids, last = self._pack_prompts(
                [np.asarray(c, np.int32) for c in cur])
            tok_h = self.run_sample(self.run_logits(tokens, pos_ids, last),
                                    temp, topk)
            for r in range(B):
                if not done[r]:
                    cur[r].append(int(tok_h[r]))
            self._emit(tok_h, outs, done, eos_id, max_new_tokens)
        return [np.asarray(o, np.int32) for o in outs]

    def _bank(self, rows):
        """The dense bank of ``rows`` rows ``generate`` decodes over, kept
        for the next call (its graphs hold its addresses); the bank of
        another row bucket is dropped first."""
        bank = self._banks.get(rows)
        if bank is None:
            self._banks.clear()
            bank = self._banks[rows] = self.new_dense_caches(rows)
        return bank

    def _pool(self, rows, kv_dtype):
        from ..serving.kvpool import KVBlockPool
        kv_dtype = kv_dtype or flag("kv_cache_dtype")
        key = (rows, kv_dtype, int(flag("kv_block_size")))
        pool = self._paged_pools.get(key)
        if pool is None:
            for old in self._paged_pools.values():    # one pool kept
                old.reset()
            self._paged_pools.clear()
            pool = KVBlockPool(
                slots=rows, num_layers=self.cfg.num_layers,
                num_heads=self.cfg.num_heads, d_head=self.cfg.d_head,
                max_seq_len=self.max_len, dtype=kv_dtype, name="offline",
                prefix_cache=False, device=self.device)
            self._paged_pools[key] = pool
        return pool
