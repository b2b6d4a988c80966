"""Port chunked (incremental) paged prefill on the CPU against the JAX
package: ``GPT.prefill_chunk_paged`` logits against the JAX chunk program
chunk by chunk, the S > 1 paged read through the gather route (which the
decode kernel refuses), and chunked admission through the decode bank
equal to monolithic admission and to JAX generate, then a full-exact
prefix hit with the same outputs (tests/test_serving_podscale.py).

Logits: atol 1e-4 (float32 on both sides, another summation order)."""
import importlib

import jax
import numpy as np
import pytest
import torch

from paddle_tpu.serving.kvpool import KVBlockPool as JPool
from paddle_tpu_torch import serving
from paddle_tpu_torch.flags import flag, set_flags
from paddle_tpu_torch.serving.batching import GenerationRequest
from paddle_tpu_torch.serving.kvpool import KVBlockPool
from torch_tiny_gpt import MAX_LEN, prompts, run_bank, tiny_pair

tpa = importlib.import_module("paddle_tpu_torch.kernels.paged_attention")


@pytest.fixture(scope="module")
def pair():
    return tiny_pair()


@pytest.fixture
def chunk_flags():
    keys = ("prefill_chunk_tokens", "kv_prefix_cache")
    saved = {k: flag(k) for k in keys}
    yield
    set_flags(saved)


@pytest.mark.parametrize("dtype", ["fp32", "int8"])
def test_prefill_chunks_match_jax_chunk_program(pair, dtype):
    """A 13-token prompt ingested in chunks of 4 (the last one ragged)
    into both packages' pools: each chunk's logits at its last real token
    agree within 1e-4, and the final one equals the monolithic prefill's
    next-token logits."""
    tgen, jgen, _ = pair
    cfg = tgen.cfg
    prompt = prompts(cfg.vocab_size, [13], seed=4)[0]
    geom = dict(slots=1, num_layers=cfg.num_layers, num_heads=cfg.num_heads,
                d_head=cfg.d_head, max_seq_len=MAX_LEN, block_size=4,
                dtype=dtype)
    jpool = JPool(name="chunk_parity", **geom)
    tpool = KVBlockPool(device="cpu", **geom)
    key = jax.random.PRNGKey(0)
    C, L = 4, prompt.size
    for s in range(0, L, C):
        take = min(C, L - s)
        toks = np.zeros((1, C), np.int32)
        toks[0, :take] = prompt[s:s + take]
        pos_ids = np.clip(np.arange(s, s + C, dtype=np.int32), 0,
                          L - 1)[None]
        args = (toks, pos_ids, np.array([s], np.int32),
                np.array([take], np.int32), np.array([take - 1], np.int32))
        for pool in (jpool, tpool):
            pool.alloc(0, s + take)
        want, key = jgen._run_prefill_chunk(*args, jpool, key)
        got = tgen.run_prefill_chunk(*args, tpool)
        np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-4,
                                   rtol=0)
    tokens, pos_ids, last = tgen._pack_prompts([prompt])
    mono, _, _ = tgen.run_prefill(tokens, pos_ids, last)
    tol = 1e-4 if dtype == "fp32" else 0.05
    np.testing.assert_allclose(got.numpy(), mono[:1].numpy(), atol=tol,
                               rtol=0)


def test_multi_query_paged_reads_take_the_gather_route():
    """S > 1 paged reads go through ``paged_attention_gather`` (the JAX
    gather composite's port); the decode kernel's checks refuse them."""
    rng = np.random.default_rng(1)
    q = torch.from_numpy(rng.normal(size=(2, 2, 3, 16)).astype(np.float32))
    kp = torch.from_numpy(rng.normal(size=(5, 2, 4, 16)).astype(np.float32))
    vp = kp + 1
    tables = torch.tensor([[1, 2], [3, 4]], dtype=torch.int32)
    pos = torch.tensor([2, 4], dtype=torch.int32)
    got = tpa.paged_attention_gather(q, kp, vp, tables, pos)
    torch.testing.assert_close(
        got, tpa.paged_attention_ref(q, kp, vp, tables, pos))
    with pytest.raises(ValueError, match="S=3"):
        tpa._check(q, kp, vp, tables, pos, None, None)
    with pytest.raises(ValueError, match="BOTH"):
        tpa.paged_attention_gather(q, kp, vp, tables, pos,
                                   k_scale=torch.ones(5, 2, 4))


def test_chunked_prefill_matches_monolithic_then_prefix_hits(pair,
                                                             chunk_flags):
    """Admission in fixed 4-token chunks interleaved with the decode bank
    gives the monolithic admission's outputs (and JAX greedy
    generate's); repeat prompts are full-exact prefix hits with the same
    outputs; the pool drains to zero live blocks while the cache keeps
    evictable ones; prefix-only incremental mode (chunk flag 0) agrees."""
    tgen, jgen, _ = pair
    ps = prompts(tgen.cfg.vocab_size, [11, 7, 13], seed=1)
    want = [g.tolist() for g in jgen.generate(ps, max_new_tokens=6,
                                              seed=0)]
    eng_a = serving.GenerationEngine(tgen, slots=4, paged=True)
    assert not eng_a.incremental_prefill_enabled()
    base = run_bank(eng_a, [GenerationRequest(p, max_new_tokens=6)
                            for p in ps])
    assert base == want and eng_a.pool.blocks_in_use() == 0

    set_flags({"prefill_chunk_tokens": 4})
    eng_b = serving.GenerationEngine(tgen, slots=4, paged=True,
                                     prefix_cache=True)
    assert eng_b.incremental_prefill_enabled()
    assert run_bank(eng_b, [GenerationRequest(p, max_new_tokens=6)
                            for p in ps]) == base
    assert eng_b.pool.blocks_in_use() == 0 and eng_b.pool.cached_blocks() > 0
    h0 = eng_b.pool.counters["prefix_hits"]
    assert run_bank(eng_b, [GenerationRequest(p, max_new_tokens=6)
                            for p in ps]) == base
    assert eng_b.pool.counters["prefix_hits"] >= h0 + len(ps)
    assert eng_b.pool.blocks_in_use() == 0

    set_flags({"prefill_chunk_tokens": 0})
    eng_c = serving.GenerationEngine(tgen, slots=4, paged=True,
                                     prefix_cache=True)
    assert eng_c.incremental_prefill_enabled()
    for _ in range(2):
        assert run_bank(eng_c, [GenerationRequest(p, max_new_tokens=6)
                                for p in ps]) == base
    assert eng_c.pool.blocks_in_use() == 0


def test_chunked_prefill_without_prefix_cache_and_mixed_bank(pair,
                                                             chunk_flags):
    """Chunking alone (no prefix cache) in a bank of 2 slots for 4
    prompts: prompts ingest while other rows decode, and every output is
    the offline one; no block stays behind."""
    tgen, _, _ = pair
    set_flags({"prefill_chunk_tokens": 3})
    ps = prompts(tgen.cfg.vocab_size, [5, 17, 9, 2], seed=6)
    want = [g.tolist() for g in tgen.generate(ps, max_new_tokens=7,
                                              paged=True)]
    eng = serving.GenerationEngine(tgen, slots=2, paged=True,
                                   prefix_cache=False)
    assert eng.incremental_prefill_enabled()
    got = run_bank(eng, [GenerationRequest(p, max_new_tokens=7)
                         for p in ps])
    assert got == want
    assert eng.pool.blocks_in_use() == 0 and eng.pool.cached_blocks() == 0


def _slot_blocks(pool, slot, n):
    """Copies of ``slot``'s first ``n`` blocks in every pool tensor."""
    ids = torch.from_numpy(pool.tables[slot, :n].astype(np.int64))
    return [t[ids].clone() for t in pool.tensors()]


def test_decode_step_leaves_a_prefilling_slot_untouched(pair, chunk_flags):
    """A decode step interleaved with a chunked prefill writes only the
    live rows' blocks: the prefilling slot's stale position (0 for a
    fresh slot) would land in a block it already filled, so its row goes
    to the trash block and its blocks stay bitwise as the chunk left
    them. Without ``live`` the same step overwrites position 0."""
    tgen, _, _ = pair
    set_flags({"prefill_chunk_tokens": 4})
    short, long_ = prompts(tgen.cfg.vocab_size, [3, 13], seed=8)
    eng = serving.GenerationEngine(tgen, slots=2, paged=True,
                                   prefix_cache=True)
    st_a = eng.start_prefill(GenerationRequest(short), 0)
    assert eng.prefill_chunk(st_a)
    tok_a = eng.finish_prefill(st_a)
    st_b = eng.start_prefill(GenerationRequest(long_), 1)
    assert not eng.prefill_chunk(st_b)
    nb = int(np.count_nonzero(eng.pool.tables[1]))
    assert nb >= 1
    before = _slot_blocks(eng.pool, 1, nb)
    args = (np.array([tok_a, 0], np.int32), np.array([short.size, 0],
                                                     np.int32),
            np.zeros(2, np.float32), np.zeros(2, np.int32))
    eng.prepare_step({0: short.size})
    eng.step(*args, live=np.array([True, False]))
    after = _slot_blocks(eng.pool, 1, nb)
    assert all(torch.equal(a, b) for a, b in zip(before, after))
    eng.step(*args)
    stale = _slot_blocks(eng.pool, 1, nb)
    assert not all(torch.equal(a, b) for a, b in zip(before, stale))


def test_chunked_admission_beside_a_decoding_row_matches_offline(
        pair, chunk_flags):
    """A short prompt decodes while a long one is admitted in 4-token
    chunks into a fresh slot (stale position 0): both outputs are the
    offline ones, the long prompt's cached blocks are bitwise those of
    the same prompt admitted alone, and a repeat of it, a full prefix hit
    on those blocks, gives the same output again."""
    tgen, _, _ = pair
    set_flags({"prefill_chunk_tokens": 4})
    ps = prompts(tgen.cfg.vocab_size, [3, 21], seed=9)
    want = [g.tolist() for g in tgen.generate(ps, max_new_tokens=8,
                                              paged=True)]

    def cached(eng, p):
        m = eng.pool.match_prefix(p)
        assert m is not None and m["tokens"] == p.size
        ids = torch.tensor(m["blocks"], dtype=torch.long)
        return [t[ids].clone() for t in eng.pool.tensors()]

    eng = serving.GenerationEngine(tgen, slots=2, paged=True,
                                   prefix_cache=True)
    got = run_bank(eng, [GenerationRequest(p, max_new_tokens=8)
                         for p in ps])
    assert got == want
    alone = serving.GenerationEngine(tgen, slots=2, paged=True,
                                     prefix_cache=True)
    assert run_bank(alone, [GenerationRequest(ps[1], max_new_tokens=8)]) \
        == want[1:]
    assert all(torch.equal(a, b) for a, b in zip(cached(eng, ps[1]),
                                                 cached(alone, ps[1])))
    h0 = eng.pool.counters["prefix_hits"]
    again = run_bank(eng, [GenerationRequest(ps[1], max_new_tokens=8)])
    assert again == want[1:]
    assert eng.pool.counters["prefix_hits"] > h0
    assert eng.pool.blocks_in_use() == 0
