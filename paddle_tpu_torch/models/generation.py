"""Autoregressive generation over the KV-cached GPT: one bucketed
prefill over the prompts, then one decode step per token.

Counterpart of ``paddle_tpu/models/generation.py`` (``GPTGenerator``).
The same power-of-two prompt packing (``_pack_prompts``), the same
emission rule (``_emit``) and the same two decode loops: the dense bank
(a ``[B, H, max_len, D]`` cache per layer) and the block-paged pool
(``serving.kvpool.KVBlockPool``). Sampling is per row (greedy where
temperature <= 0, else temperature/top-k) and draws from a
``torch.Generator`` seeded from ``seed``; greedy output does not depend
on it.

    gen = GPTGenerator(cfg, params, max_len=512)           # on the GPU
    outs = gen.generate([prompt_ids], max_new_tokens=64, paged=True)
"""
import contextlib
import time

import numpy as np
import torch

from ..device import resolve_device
from ..flags import flag
from ..ops.decode_ops import sample_tokens
from ..serving.batching import next_bucket
from .gpt import GPT


def length_bucket(n, lo=1):
    """Smallest power-of-two >= n (>= lo): the prefill length and batch
    buckets, shared with the serving batcher."""
    return next_bucket(n, min_bucket=lo)


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
        # (rows, kv dtype, block size) -> KVBlockPool reused across
        # generate(paged=True) calls; blocks are freed after every call
        self._paged_pools = {}

    # -- stage runners ----------------------------------------------------
    @contextlib.contextmanager
    def _stage(self, stage):
        if self.stats is None:
            yield
            return
        t0 = time.perf_counter()
        yield
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)
        self.stats.hist[stage].observe(time.perf_counter() - t0)

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
        with self._stage("prefill"):
            return self.model.prefill(self._dev(tokens), self._dev(pos_ids),
                                      self._dev(last_pos))

    def run_decode(self, token, pos, cache_k, cache_v):
        with self._stage("decode"):
            return self.model.decode_step(self._dev(token), self._dev(pos),
                                          cache_k, cache_v)

    def run_decode_paged(self, token, pos, pool):
        with self._stage("decode"):
            return self.model.decode_step_paged(
                self._dev(token), self._dev(pos), pool.device_tables(),
                pool.layers())

    def run_sample(self, logits, temperature, top_k, generator):
        """Logits on the device -> np.int32 tokens on the host."""
        with self._stage("sample"):
            topk = np.asarray(top_k)
            toks = sample_tokens(
                logits, torch.as_tensor(np.asarray(temperature, np.float32)),
                torch.as_tensor(topk) if (topk > 0).any() else None,
                generator=generator)
            return toks.cpu().numpy()

    def new_rng(self, seed):
        return torch.Generator(device=self.device).manual_seed(
            0 if seed is None else int(seed))

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
        generate() and the serving engine."""
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
                 kv_dtype=None):
        """KV-cached generation. ``prompts`` is a list of 1-D int token
        arrays (ragged lengths fine). Returns a list of 1-D int32 arrays
        of NEW tokens (generation stops at ``eos_id``, which is not
        included). ``paged`` (None -> ``FLAGS_kv_paged``) decodes over a
        block-paged pool instead of the dense bank, with ``kv_dtype``
        (None -> ``FLAGS_kv_cache_dtype``) as its element type; greedy
        output is the same either way."""
        if paged is None:
            paged = bool(flag("kv_paged"))
        prompts, lens = self._prep(prompts, max_new_tokens)
        B = len(prompts)
        tokens, pos_ids, last = self._pack_prompts(prompts)
        bb, s = tokens.shape
        temp = np.full((bb,), float(temperature), np.float32)
        topk = np.full((bb,), int(top_k), np.int32)
        rng = self.new_rng(seed)
        pool = self._pool(bb, kv_dtype) if paged else None
        try:
            logits, ks, vs = self.run_prefill(tokens, pos_ids, last)
            if paged:
                for r in range(B):
                    pool.alloc(r, lens[r])
                pool.scatter_prefill(list(range(B)), ks, vs, s)
            else:
                cache_k, cache_v = self.new_dense_caches(bb)
                for c, new in zip(cache_k + cache_v, ks + vs):
                    c[:, :, :s] = new
            del ks, vs
            tok_h = self.run_sample(logits, temp, topk, rng)
            outs = [[] for _ in range(B)]
            done = np.zeros(B, bool)
            # pos[r] = cache slot the NEXT fed token lands in
            pos = np.zeros((bb,), np.int32)
            pos[:B] = np.asarray(lens, np.int32)
            self._emit(tok_h, outs, done, eos_id, max_new_tokens)
            while not done.all():
                if paged:
                    for r in range(B):
                        if not done[r]:          # allocation-on-append
                            pool.ensure(r, int(pos[r]))
                    logits = self.run_decode_paged(tok_h, pos, pool)
                else:
                    logits = self.run_decode(tok_h, pos, cache_k, cache_v)
                tok_h = self.run_sample(logits, temp, topk, rng)
                pos[:B] = np.where(done, pos[:B], pos[:B] + 1)
                self._emit(tok_h, outs, done, eos_id, max_new_tokens)
                if self.stats:
                    self.stats.bump("decode_steps")
            if self.stats:
                self.stats.bump("tokens_generated",
                                int(sum(len(o) for o in outs)))
            return [np.asarray(o, np.int32) for o in outs]
        finally:
            if pool is not None:
                # keep the pool object for the next call, but free its
                # blocks and its device memory
                for r in range(bb):
                    pool.free_slot(r)
                pool.drop_device()

    def _pool(self, rows, kv_dtype):
        from ..serving.kvpool import KVBlockPool
        kv_dtype = kv_dtype or flag("kv_cache_dtype")
        key = (rows, kv_dtype, int(flag("kv_block_size")))
        pool = self._paged_pools.get(key)
        if pool is None:
            pool = KVBlockPool(
                slots=rows, num_layers=self.cfg.num_layers,
                num_heads=self.cfg.num_heads, d_head=self.cfg.d_head,
                max_seq_len=self.max_len, dtype=kv_dtype,
                device=self.device)
            self._paged_pools[key] = pool
        return pool
