"""The port's captured decode step (``framework.cuda_graph.CapturedDecode``)
on the CPU, where its body runs over the static tensors: equal bitwise to
the plain decode step and sampler, its eager twin equal to a run, its
graph cache keyed by signature and dropping entries whose storage was
released; the capturable sampler (inverse-CDF draws, the greedy mode);
and the reference paths: ``generate_naive`` equal to ``generate`` and to
the JAX package's, ``GPT.logits`` within 1e-4 of max |ref| of JAX
``gpt_logits`` (tests/test_decode.py)."""
import jax
import numpy as np
import pytest
import torch

from paddle_tpu_torch import serving
from paddle_tpu_torch.ops.decode_ops import draw_tokens, sample_tokens
from paddle_tpu_torch.serving.batching import GenerationRequest
from paddle_tpu_torch.serving.kvpool import KVBlockPool
from torch_tiny_gpt import MAX_LEN, prompts, run_bank, tiny_pair


@pytest.fixture(scope="module")
def pair():
    return tiny_pair()


def _prefilled(tgen, paged, ps):
    """A storage holding ``ps``'s prefill: a dense bank or a pool."""
    tokens, pos_ids, last = tgen._pack_prompts(ps)
    bb, s = tokens.shape
    logits, ks, vs = tgen.run_prefill(tokens, pos_ids, last)
    if not paged:
        bank = tgen.new_dense_caches(bb)
        for c, new in zip(bank[0] + bank[1], ks + vs):
            c[:, :, :s] = new
        return bank, logits
    cfg = tgen.cfg
    pool = KVBlockPool(slots=bb, num_layers=cfg.num_layers,
                       num_heads=cfg.num_heads, d_head=cfg.d_head,
                       max_seq_len=MAX_LEN, block_size=8, device="cpu")
    for r, p in enumerate(ps):
        pool.alloc(r, p.size + 8)
    pool.scatter_prefill(list(range(len(ps))), ks, vs, s)
    return pool, logits


def _tensors(kv):
    return kv.tensors() if hasattr(kv, "tensors") else kv[0] + kv[1]


def _clone(kv):
    if not hasattr(kv, "tensors"):
        return ([t.clone() for t in kv[0]], [t.clone() for t in kv[1]])
    twin = KVBlockPool(slots=kv.slots, num_layers=kv.num_layers,
                       num_heads=kv.num_heads, d_head=kv.d_head,
                       max_seq_len=kv.max_seq_len, block_size=kv.block_size,
                       device="cpu")
    twin.tables[:] = kv.tables
    for a, b in zip(twin.tensors(), kv.tensors()):
        a.copy_(b)
    return twin


@pytest.mark.parametrize("paged", [False, True])
@pytest.mark.parametrize("temperature", [0.0, 0.8])
def test_captured_body_equals_the_plain_step(pair, paged, temperature):
    """Four steps through the decoder and through the model's decode
    step + ``sample_tokens`` from twin storages and generator states:
    tokens, logits and every storage tensor bitwise equal."""
    tgen, _, _ = pair
    ps = prompts(tgen.cfg.vocab_size, [5, 9, 12])
    kv, logits = _prefilled(tgen, paged, ps)
    twin = _clone(kv)
    rows = len(kv.tables) if paged else kv[0][0].shape[0]
    dec = tgen.new_decoder(seed=5)
    plain_gen = torch.Generator().manual_seed(5)
    temp = np.full(rows, temperature, np.float32)
    topk = np.array([0, 40, 3, 0], np.int32)[:rows]
    tok = torch.argmax(logits, -1).numpy().astype(np.int32)
    pos = np.array([p.size for p in ps] + [0], np.int32)[:rows]
    for _ in range(4):
        got = dec.run(tok, pos, temp, topk, kv)
        t, p = torch.from_numpy(tok).long(), torch.from_numpy(pos).long()
        if paged:
            want_logits = tgen.model.decode_step_paged(
                t, p, twin.device_tables(), twin.layers())
        else:
            want_logits = tgen.model.decode_step(t, p, twin[0], twin[1])
        want = sample_tokens(want_logits, torch.from_numpy(temp),
                             torch.from_numpy(topk).long(),
                             generator=plain_gen,
                             greedy=temperature <= 0).numpy()
        np.testing.assert_array_equal(got, want)
        assert torch.equal(dec.logits, want_logits)
        for a, b in zip(_tensors(kv), _tensors(twin)):
            assert torch.equal(a, b)
        tok, pos = got, pos + 1
    assert dec.steps["paged" if paged else "dense"] == 4


def test_eager_twin_equals_a_run(pair):
    """From the same generator state the eager twin and a run give the
    same tokens and logits, greedy and stochastic."""
    tgen, _, _ = pair
    ps = prompts(tgen.cfg.vocab_size, [6, 11])
    pool, logits = _prefilled(tgen, True, ps)
    dec = tgen.new_decoder()
    tok = torch.argmax(logits, -1).numpy().astype(np.int32)
    pos = np.array([6, 11], np.int32)
    for temp in (np.zeros(2, np.float32), np.array([0.0, 0.8], np.float32)):
        topk = np.array([0, 40], np.int32)
        dec.generator.manual_seed(3)
        a = dec.eager(tok, pos, temp, topk, pool)
        la = dec.logits.clone()
        dec.generator.manual_seed(3)
        b = dec.run(tok, pos, temp, topk, pool)
        np.testing.assert_array_equal(a, b)
        assert torch.equal(la, dec.logits)


def test_decoder_cache_is_keyed_by_signature(pair):
    """One entry per (rows, dense or paged, kv dtype, block size, blocks
    a row, sampling mode) and storage; an entry whose storage was
    released is dropped and built anew, never reused."""
    tgen, _, _ = pair
    ps = prompts(tgen.cfg.vocab_size, [4, 7])
    pool, _ = _prefilled(tgen, True, ps)
    bank = tgen.new_dense_caches(2)
    dec = tgen.new_decoder()
    tok, pos = np.array([3, 4], np.int32), np.array([4, 7], np.int32)
    greedy, mixed = np.zeros(2, np.float32), np.array([0.0, 1.0], np.float32)
    topk = np.zeros(2, np.int32)
    for kv, temp in ((bank, greedy), (bank, greedy), (bank, mixed),
                     (pool, greedy), (pool, greedy)):
        dec.run(tok, pos, temp, topk, kv)
    st = dec.cache.stats()
    assert (st["entries"], st["hits"], st["misses"]) == (3, 2, 3)
    sig = dec.signature(2, pool, True)
    assert sig[:6] == (2, "paged", "fp32", 8, pool.blocks_per_row, True)
    assert dec.signature(2, bank, False)[:6] == (2, "dense", "fp32", 0, 0,
                                                 False)
    assert dec.cache.get(sig).alive()
    pool.drop_device()                 # the graph's storage is gone
    assert not dec.cache.get(sig).alive()
    dec.run(tok, pos, greedy, topk, pool)
    assert len(dec.cache) == 3         # the dead entry left, a new one came
    assert all(e.alive() for e in dec.cache.values())
    dec.clear()
    assert len(dec.cache) == 0 and dec.logits is None


def test_draw_tokens_inverse_cdf():
    """Never a zero-probability index; the empirical marginal is the
    distribution (atol 0.02 over 20000 draws); the same bits from the
    same generator state."""
    p = torch.tensor([0.0, 0.1, 0.0, 0.6, 0.3, 0.0])
    probs = p.expand(20000, -1).contiguous()
    a = draw_tokens(probs, torch.Generator().manual_seed(1))
    b = draw_tokens(probs, torch.Generator().manual_seed(1))
    assert torch.equal(a, b)
    emp = torch.bincount(a, minlength=6).float() / 20000
    assert float(emp[p == 0].sum()) == 0.0
    torch.testing.assert_close(emp, p, atol=0.02, rtol=0)


def test_sample_tokens_modes():
    """The greedy mode draws nothing; the mixed mode gives greedy rows
    their argmax and equals the greedy mode when every row is greedy;
    without a mode the host temperatures decide."""
    logits = torch.randn(4, 16, generator=torch.Generator().manual_seed(0))
    zero = torch.zeros(4)
    gen = torch.Generator().manual_seed(2)
    state = gen.get_state()
    greedy = sample_tokens(logits, zero, generator=gen, greedy=True)
    assert torch.equal(gen.get_state(), state)
    assert torch.equal(greedy, torch.argmax(logits, -1).int())
    mixed = sample_tokens(logits, zero, torch.zeros(4, dtype=torch.long),
                          generator=gen, greedy=False)
    assert torch.equal(mixed, greedy)
    temp = torch.tensor([0.0, 1.0, 0.0, 1.0])
    out = sample_tokens(logits, temp, generator=gen)
    assert torch.equal(out[temp <= 0], greedy[temp <= 0])


@pytest.mark.parametrize("paged", [False, True])
def test_generate_naive_equals_generate_and_jax(pair, paged):
    """Greedy KV-cached generation (decode through the decoder) is token
    for token the full-recompute ``generate_naive``, and both are the JAX
    package's ``generate_naive``."""
    tgen, jgen, _ = pair
    ps = prompts(tgen.cfg.vocab_size, (5, 9, 12))
    kv = tgen.generate(ps, max_new_tokens=14, seed=0, paged=paged)
    naive = tgen.generate_naive(ps, max_new_tokens=14, seed=0)
    want = jgen.generate_naive(ps, max_new_tokens=14, seed=0)
    for a, b, c in zip(kv, naive, want):
        assert a.dtype == np.int32 and a.shape == (14,)
        np.testing.assert_array_equal(a, b)
        np.testing.assert_array_equal(b, c)


def test_gpt_logits_match_jax_gpt_logits(pair):
    """``GPT.logits`` (the full forward, flash attention) against JAX
    ``gpt_logits`` at two buckets: within 1e-4 of max |ref|; padding to a
    larger bucket changes nothing beyond that."""
    tgen, jgen, _ = pair
    prompt = prompts(tgen.cfg.vocab_size, (9,), seed=5)[0]
    got = {}
    for bucket in (16, 32):
        toks = np.zeros((1, bucket), np.int32)
        toks[0, :prompt.size] = prompt
        pos_ids = np.arange(bucket, dtype=np.int32)[None, :]
        last = np.array([prompt.size - 1], np.int32)
        want, _ = jgen._run_logits(toks, pos_ids, last,
                                   jax.random.PRNGKey(0))
        want = np.asarray(want)
        got[bucket] = tgen.run_logits(toks, pos_ids, last).numpy()
        np.testing.assert_allclose(got[bucket], want,
                                   atol=1e-4 * np.abs(want).max(), rtol=0)
    np.testing.assert_allclose(got[32], got[16],
                               atol=1e-4 * np.abs(got[16]).max(), rtol=0)


def test_generate_reuses_its_storage_and_release_frees_it(pair):
    """``generate`` decodes over one cached pool (and bank) per shape, so
    its graphs are reused call over call; ``release`` drops them."""
    tgen, _, _ = pair
    ps = prompts(tgen.cfg.vocab_size, (5, 9))
    tgen.release()
    a = tgen.generate(ps, max_new_tokens=6, paged=True)
    n = len(tgen.decoder.cache)
    b = tgen.generate(ps, max_new_tokens=6, paged=True)
    assert len(tgen.decoder.cache) == n == 1
    for x, y in zip(a, b):
        np.testing.assert_array_equal(x, y)
    pool = next(iter(tgen._paged_pools.values()))
    assert pool.blocks_in_use() == 0
    tgen.release()
    assert len(tgen.decoder.cache) == 0 and not tgen._paged_pools


def test_engine_steps_through_its_decoder(pair):
    """The serving bank decodes through the engine's own decoder (one
    entry per sampling mode), with the offline outputs."""
    tgen, _, _ = pair
    ps = prompts(tgen.cfg.vocab_size, (5, 9, 3))
    eng = serving.GenerationEngine(tgen, slots=4, paged=True)
    got = run_bank(eng, [GenerationRequest(p, max_new_tokens=5)
                         for p in ps])
    assert got == [g.tolist() for g in tgen.generate(ps, max_new_tokens=5,
                                                     paged=True)]
    assert eng.decoder is not tgen.decoder
    assert eng.decoder.steps["paged"] >= 4 and len(eng.decoder.cache) == 1


def test_generate_keeps_one_storage_of_each_kind(pair):
    """``generate`` keeps the latest row bucket's dense bank and pool
    only: another bucket (or kv dtype) drops the earlier storage, and
    graphs over the dropped storage are captured anew, never replayed;
    the outputs stay the first call's."""
    tgen, _, _ = pair
    one = prompts(tgen.cfg.vocab_size, (6,), seed=11)
    three = prompts(tgen.cfg.vocab_size, (6, 4, 9), seed=12)
    tgen.release()
    for paged in (False, True):
        a = tgen.generate(one, max_new_tokens=5, paged=paged)
        tgen.generate(three, max_new_tokens=5, paged=paged)
        b = tgen.generate(one, max_new_tokens=5, paged=paged)
        np.testing.assert_array_equal(a[0], b[0])
    assert len(tgen._banks) == 1 and len(tgen._paged_pools) == 1
    tgen.generate(one, max_new_tokens=5, paged=True, kv_dtype="int8")
    (key, pool), = tgen._paged_pools.items()
    assert key[1] == "int8" and pool.blocks_in_use() == 0
    tgen.release()
