"""Port block-granular prefix cache (paddle_tpu_torch.serving.kvpool) on
the CPU: refcounted sharing, copy-on-write, LRU eviction and the leak
sweep (the assertions of tests/test_serving_podscale.py), the prefix key
shared with the JAX package, and a prefix hit through the decode bank
giving the uncached outputs and the JAX package's."""
import numpy as np
import pytest
import torch

from paddle_tpu.serving.kvpool import prompt_prefix_key as jkey
from paddle_tpu_torch import serving
from paddle_tpu_torch.flags import flag, set_flags
from paddle_tpu_torch.serving.batching import GenerationRequest
from paddle_tpu_torch.serving.kvpool import KVBlockPool, prompt_prefix_key
from torch_tiny_gpt import prompts, run_bank, tiny_pair


def _pool(**kw):
    kw.setdefault("slots", 4)
    kw.setdefault("num_layers", 2)
    kw.setdefault("num_heads", 2)
    kw.setdefault("d_head", 8)
    kw.setdefault("max_seq_len", 64)
    kw.setdefault("block_size", 4)
    kw.setdefault("prefix_cache", True)
    kw.setdefault("device", "cpu")
    return KVBlockPool(**kw)


@pytest.fixture(scope="module")
def pair():
    return tiny_pair()


@pytest.fixture
def pool_flags():
    keys = ("prefill_chunk_tokens", "kv_prefix_cache")
    saved = {k: flag(k) for k in keys}
    yield
    set_flags(saved)


def test_prefix_key_is_the_jax_key():
    rng = np.random.default_rng(0)
    for n in (1, 7, 16):
        toks = rng.integers(0, 32000, n).astype(np.int32)
        assert prompt_prefix_key(toks) == jkey(toks)
        assert prompt_prefix_key(list(toks), 3) == jkey(toks, 3)


def test_shared_block_leak_sweep_256_steps():
    """256 admission cycles of fresh prefills, deposits and adoptions over
    rotating slots: after every free the live blocks are exactly the
    cache-shared set, and a reset returns the full free list."""
    p = _pool(num_blocks=65)
    rng = np.random.default_rng(7)
    ps = [rng.integers(1, 100, n).astype(np.int32) for n in (8, 12, 16, 9)]
    for step in range(256):
        slot = step % p.slots
        prompt = ps[step % len(ps)]
        m = p.match_prefix(prompt)
        if m is not None and m["tokens"] == len(prompt):
            p.adopt_prefix(slot, m)
        else:
            p.alloc(slot, len(prompt))
            p.prefix_insert(prompt, slot)
        assert p.free_slot(slot) >= 0
        assert p.blocks_in_use() == 0, step
        assert p.stats()["evictable_blocks"] == p.cached_blocks()
        held = sum(p._refs.get(b, 0) > 0 for b in range(1, p.num_blocks))
        assert held == p.cached_blocks(), step
    assert p.cached_blocks() > 0
    p.reset()
    assert p.cached_blocks() == 0 and p.blocks_in_use() == 0
    assert len(p._free) == p.capacity_blocks


def test_reclaim_leaks_keeps_shared_blocks():
    """The leak sweep on a slot holding cached (shared) blocks frees only
    the exclusively owned ones; the cache keeps its blocks, adoptable."""
    p = _pool(num_blocks=33)
    prompt = np.arange(1, 9, dtype=np.int32)      # 2 blocks at bs=4
    p.alloc(0, len(prompt))
    p.prefix_insert(prompt, 0)                    # blocks now shared
    p.alloc(1, 5)                                 # an unshared leak too
    assert p.blocks_in_use() == 4
    assert p.reclaim_leaks(live_slots=[]) == 2
    assert p.blocks_in_use() == 0 and p.cached_blocks() == 2
    assert p.holders() == {}
    assert p.counters["leaked_blocks"] == 2
    m = p.match_prefix(prompt)
    assert m is not None and m["tokens"] == len(prompt)


@pytest.mark.parametrize("dtype", ["fp32", "bf16", "int8"])
def test_prepare_write_copies_shared_blocks_on_the_device(dtype):
    """Copy-on-write: a slot that adopted cached blocks gets fresh copies
    of the blocks it writes (every pool tensor, scales included, bitwise)
    while the cache keeps the originals; unshared blocks are not
    copied."""
    p = _pool(num_layers=1, num_blocks=17, dtype=dtype)
    prompt = np.arange(1, 11, dtype=np.int32)     # 3 blocks, last partial
    p.alloc(0, len(prompt))
    gen = torch.Generator().manual_seed(0)
    for t in p.tensors():
        t.copy_((torch.randn(t.shape, generator=gen) * 50).to(t.dtype))
    p.prefix_insert(prompt, 0)
    p.free_slot(0)
    m = p.match_prefix(prompt)
    p.adopt_prefix(1, m)
    cached = [int(b) for b in m["blocks"]]
    assert p.prepare_write(1, 9, 11) == 1         # the tail block only
    new = int(p.tables[1, 2])
    assert new not in cached and list(p.tables[1, :2]) == cached[:2]
    for t in p.tensors():
        assert torch.equal(t[new], t[cached[2]])
    assert p.prepare_write(1, 9, 11) == 0         # now its own
    assert p.counters["prefix_cow_copies"] == 1
    p.free_slot(1)
    assert p.blocks_in_use() == 0 and p.cached_blocks() == 3


def test_cold_prefixes_evict_lru_under_pressure():
    """A full pool evicts the least recently used prefix entries to admit
    an allocation; a hit refreshes an entry's place."""
    p = _pool(num_blocks=9)                       # 8 allocatable
    a, b = np.arange(1, 9, dtype=np.int32), np.arange(20, 28,
                                                      dtype=np.int32)
    for slot, prompt in ((0, a), (1, b)):
        p.alloc(slot, len(prompt))
        p.prefix_insert(prompt, slot)
        p.free_slot(slot)
    assert p.cached_blocks() == 4
    assert p.match_prefix(a) is not None          # a is now the newest
    p.alloc(2, 24)                                # 6 blocks: evict b
    assert p.match_prefix(b) is None and p.match_prefix(a) is not None
    assert p.counters["prefix_evictions"] == 1
    with pytest.raises(serving.KVPoolExhaustedError):
        p.alloc(3, 24)                            # a goes, still short
    assert p.tables[3].sum() == 0


def test_prefix_hit_through_the_bank_keeps_outputs(pair, pool_flags):
    """Repeat prompts through the decode bank adopt their cached blocks
    (a full hit replays one token, a shared head copy-on-writes at the
    divergence) with the outputs of an uncached engine and of JAX greedy
    generate; the first prompt replays its protected blocks unchanged."""
    tgen, jgen, _ = pair
    rng = np.random.default_rng(2)
    head = rng.integers(1, 128, 8).astype(np.int32)
    pA = np.concatenate([head, rng.integers(1, 128, 3).astype(np.int32)])
    pB = np.concatenate([head, rng.integers(1, 128, 5).astype(np.int32)])
    want = [g.tolist() for g in jgen.generate([pA, pB], max_new_tokens=6,
                                              seed=0)]
    ref = run_bank(serving.GenerationEngine(tgen, slots=4, paged=True,
                                            kv_block_size=4),
                   [GenerationRequest(p, max_new_tokens=6)
                    for p in (pA, pB)])
    assert ref == want
    set_flags({"prefill_chunk_tokens": 4})
    eng = serving.GenerationEngine(tgen, slots=4, paged=True,
                                   kv_block_size=4, prefix_cache=True)
    outA = run_bank(eng, [GenerationRequest(pA, max_new_tokens=6)])
    hits = eng.pool.counters["prefix_hits"]
    outB = run_bank(eng, [GenerationRequest(pB, max_new_tokens=6)])
    assert eng.pool.counters["prefix_hits"] > hits
    assert outA + outB == ref
    assert eng.pool.counters["prefix_cow_copies"] >= 1
    assert run_bank(eng, [GenerationRequest(pA, max_new_tokens=6)]) \
        == ref[:1]
    assert eng.pool.counters["prefix_tokens_reused"] >= 8 + 11
    assert eng.pool.blocks_in_use() == 0
    st = eng.pool.stats()
    assert st["prefix_entries"] > 0 and st["evictable_blocks"] > 0


def test_warm_first_token_logits_match_cold(pair, pool_flags):
    """A cached full prompt replays its last token as a one-token chunk:
    its first-token logits equal the cold prefill's within 1e-5."""
    tgen, _, _ = pair
    eng = serving.GenerationEngine(tgen, slots=2, paged=True,
                                   kv_block_size=4, prefix_cache=True)
    prompt = prompts(128, [13], seed=8)[0]
    logits = []
    for _ in range(2):
        st = eng.start_prefill(GenerationRequest(prompt), 0)
        while not eng.prefill_chunk(st):
            pass
        logits.append(st["first_logits"])
        eng.finish_prefill(st)
        eng.release_slot(0)
    assert eng.pool.counters["prefix_hits"] == 1
    torch.testing.assert_close(logits[1], logits[0], atol=1e-5, rtol=0)
