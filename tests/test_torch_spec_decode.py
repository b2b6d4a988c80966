"""Port speculative decoding (paddle_tpu_torch) against the JAX package on
the CPU: the ``spec_accept`` op (greedy rows bitwise the JAX op's,
stochastic rows held to the target marginal), speculative greedy
generation equal to non-speculative greedy and to JAX
``generate(spec_k=...)`` on the dense bank and the paged pool, the
drafters, the copy-on-write barrier before a speculative write into
shared blocks, and zero leaked blocks over 256 verify steps with
partial rejections (the assertions of tests/test_spec_decode.py)."""
import jax
import numpy as np
import pytest
import torch

from paddle_tpu.models.generation import NgramDrafter as JNgram
from paddle_tpu_torch import serving
from paddle_tpu_torch.flags import flag, set_flags
from paddle_tpu_torch.models.generation import (ModelDrafter, NgramDrafter,
                                                make_drafter)
from paddle_tpu_torch.ops.decode_ops import spec_accept
from paddle_tpu_torch.serving.batching import GenerationRequest
from paddle_tpu_torch.serving.metrics import ServingStats
from torch_tiny_gpt import prompts, repetitive_prompt, run_bank, tiny_pair


@pytest.fixture(scope="module")
def pair():
    return tiny_pair()


@pytest.fixture
def spec_flags():
    keys = ("decode_spec_k", "decode_spec_mode", "kv_paged",
            "kv_prefix_cache", "prefill_chunk_tokens")
    saved = {k: flag(k) for k in keys}
    yield
    set_flags(saved)


def _port_accept(logits, draft, temp, topk, nd, seed=0, greedy=None):
    gen = torch.Generator().manual_seed(seed)
    out, acc = spec_accept(torch.from_numpy(logits), torch.from_numpy(draft),
                           torch.from_numpy(temp), torch.from_numpy(nd),
                           top_k=torch.from_numpy(topk), generator=gen,
                           greedy=greedy)
    return out.numpy(), acc.numpy()


@pytest.mark.parametrize("K", [1, 3])
def test_spec_accept_greedy_rows_match_jax_op(pair, K):
    """Greedy rows (temperature <= 0) of a mixed batch: tokens and
    accepted counts bitwise the JAX op's (no randomness enters them);
    an all-greedy batch takes the draw-free path to the same bits."""
    _, jgen, _ = pair
    B, V = 8, 32
    rng = np.random.default_rng(K)
    logits = rng.normal(size=(B, K + 1, V)).astype(np.float32)
    greedy = logits.argmax(-1).astype(np.int32)
    draft = greedy[:, :K].copy()
    for b in range(B):                   # a wrong draft at a row's own place
        j = b % (K + 1)
        if j < K:
            draft[b, j] = (draft[b, j] + 1) % V
    temp = np.where(np.arange(B) % 2 == 0, 0.0, 0.9).astype(np.float32)
    topk = np.array([0, 4] * (B // 2), np.int32)
    nd = (np.arange(B) % (K + 1)).astype(np.int32)
    want_out, want_acc, _ = jgen._run_spec_accept(
        logits, draft, temp, topk, nd, jax.random.PRNGKey(1))
    got_out, got_acc = _port_accept(logits, draft, temp, topk, nd)
    rows = temp <= 0
    np.testing.assert_array_equal(got_acc[rows], np.asarray(want_acc)[rows])
    np.testing.assert_array_equal(got_out[rows], np.asarray(want_out)[rows])
    zero = np.zeros_like(temp)
    want_out, want_acc, _ = jgen._run_spec_accept(
        logits, draft, zero, topk, nd, jax.random.PRNGKey(2))
    for g in (True, None):
        got_out, got_acc = _port_accept(logits, draft, zero, topk, nd,
                                        greedy=g)
        np.testing.assert_array_equal(got_acc, np.asarray(want_acc))
        np.testing.assert_array_equal(got_out, np.asarray(want_out))


def test_spec_accept_greedy_semantics():
    """The argmax-chain prefix of the draft is accepted, then the argmax
    correction (or bonus) token."""
    V = 6
    logits = np.zeros((2, 3, V), np.float32)
    logits[:, 0, 2] = 5.0
    logits[:, 1, 4] = 5.0
    logits[:, 2, 1] = 5.0
    draft = np.array([[2, 4], [2, 3]], np.int32)
    out, acc = _port_accept(logits, draft, np.zeros(2, np.float32),
                            np.zeros(2, np.int32), np.full(2, 2, np.int32))
    assert acc.tolist() == [2, 1]
    assert out[0, :3].tolist() == [2, 4, 1]
    assert out[1, :2].tolist() == [2, 4]


def test_spec_accept_marginal_matches_target_distribution():
    """Point-mass rejection sampling keeps the target distribution: over
    20000 rows the draft is accepted at rate p(draft) and the first
    emitted token's marginal is p (atol 0.02, as the JAX test); a fixed
    generator state gives the same bits."""
    B, V = 20000, 8
    row = np.random.default_rng(0).normal(size=(V,)).astype(np.float32)
    logits = np.broadcast_to(row, (B, 2, V)).copy()
    draft = np.full((B, 1), 3, np.int32)
    temp = np.ones((B,), np.float32)
    topk = np.zeros((B,), np.int32)
    nd = np.ones((B,), np.int32)
    out, acc = _port_accept(logits, draft, temp, topk, nd, seed=7)
    p = np.exp(row - row.max())
    p /= p.sum()
    assert abs(acc.mean() - p[3]) < 0.02
    np.testing.assert_allclose(np.bincount(out[:, 0], minlength=V) / B, p,
                               atol=0.02)
    out2, acc2 = _port_accept(logits, draft, temp, topk, nd, seed=7)
    np.testing.assert_array_equal(out, out2)
    np.testing.assert_array_equal(acc, acc2)


@pytest.mark.parametrize("paged", [False, True])
def test_spec_greedy_equals_nonspec_and_jax(pair, spec_flags, paged):
    """Greedy generation with speculation is the non-speculative output,
    for a high-acceptance (repetitive) and low-acceptance (random)
    prompt alike, and the JAX package's generate(spec_k=K) token for
    token."""
    tgen, jgen, _ = pair
    ps = [repetitive_prompt(12)] + prompts(tgen.cfg.vocab_size, [9, 7])
    ref = tgen.generate(ps, max_new_tokens=10, seed=0, paged=paged,
                        spec_k=0)
    for k in (2, 4):
        want = jgen.generate(ps, max_new_tokens=10, seed=0, paged=paged,
                             spec_k=k)
        got = tgen.generate(ps, max_new_tokens=10, seed=0, paged=paged,
                            spec_k=k)
        for a, b, c in zip(got, ref, want):
            np.testing.assert_array_equal(a, b)
            np.testing.assert_array_equal(a, c)


def test_model_drafter_shares_weights_and_keeps_greedy(pair, spec_flags):
    """The 1-layer model drafter runs over the target's own parameter
    tensors, and speculation with it leaves greedy output unchanged."""
    tgen, _, _ = pair
    d = ModelDrafter.from_generator(tgen, num_layers=1)
    assert d.gen.cfg.num_layers == 1
    for name in ("word_embedding", "decoder_layer_0_qkv.w_0"):
        assert d.gen.model.param(name).data_ptr() \
            == tgen.model.param(name).data_ptr()
    ps = [repetitive_prompt(10)] + prompts(tgen.cfg.vocab_size, [8])
    for paged in (False, True):
        ref = tgen.generate(ps, max_new_tokens=8, paged=paged, spec_k=0)
        got = tgen.generate(ps, max_new_tokens=8, paged=paged, spec_k=3,
                            spec_mode="model")
        for a, b in zip(got, ref):
            np.testing.assert_array_equal(a, b)


def test_ngram_drafter_matches_jax_and_registry():
    """The prompt-lookup drafter proposes what the JAX one proposes, on
    cycling and random contexts; make_drafter resolves the modes."""
    jd, td = JNgram(), NgramDrafter()
    rng = np.random.default_rng(4)
    ctxs = [np.array([1, 2, 3] * 5, np.int32), np.array([4], np.int32),
            repetitive_prompt(11)]
    ctxs += [rng.integers(1, 6, n).astype(np.int32) for n in (5, 9, 17, 30)]
    for ctx in ctxs:
        for k in (1, 4):
            np.testing.assert_array_equal(td.draft(ctx, k), jd.draft(ctx, k))
    np.testing.assert_array_equal(td.draft(ctxs[0], 4), [1, 2, 3, 1])
    assert isinstance(make_drafter("ngram"), NgramDrafter)
    with pytest.raises(ValueError):
        make_drafter("no_such_mode")
    with pytest.raises(ValueError, match="target generator"):
        make_drafter("model")


def test_spec_stochastic_seeded_dense_equals_paged(pair, spec_flags):
    """Seeded stochastic speculation is reproducible call over call, and
    the dense bank and the paged pool draw the same tokens."""
    tgen, _, _ = pair
    ps = [repetitive_prompt(10)] + prompts(tgen.cfg.vocab_size, [8])
    outs = {}
    for paged in (False, True):
        a = tgen.generate(ps, max_new_tokens=8, temperature=0.9, top_k=8,
                          seed=11, paged=paged, spec_k=4)
        b = tgen.generate(ps, max_new_tokens=8, temperature=0.9, top_k=8,
                          seed=11, paged=paged, spec_k=4)
        for x, y in zip(a, b):
            np.testing.assert_array_equal(x, y)
        outs[paged] = a
    for x, y in zip(outs[False], outs[True]):
        np.testing.assert_array_equal(x, y)


def test_spec_cow_fires_before_speculative_write_on_shared_blocks(
        pair, spec_flags):
    """A request adopting cached prefix blocks speculates multi-token
    writes into the shared tail block: the copy-on-write lands before the
    write (rejected positions too), so the cached prompt replays with the
    same output and nothing leaks."""
    tgen, _, _ = pair
    prompt = repetitive_prompt(11)       # odd length: an unaligned tail
    ref = run_bank(serving.GenerationEngine(tgen, slots=2, paged=True,
                                            kv_block_size=4),
                   [GenerationRequest(prompt, max_new_tokens=8)])
    set_flags({"prefill_chunk_tokens": 0})
    eng = serving.GenerationEngine(tgen, slots=2, paged=True,
                                   kv_block_size=4, prefix_cache=True)
    for _ in range(3):                   # the 2nd and 3rd adopt the blocks
        out = run_bank(eng, [GenerationRequest(prompt, max_new_tokens=8)],
                       spec_k=4)
        assert out == ref
        assert eng.pool.blocks_in_use() == 0
    assert eng.pool.counters["prefix_hits"] >= 2
    assert eng.pool.counters["prefix_cow_copies"] >= 1


def test_spec_partial_rejection_leaks_zero_blocks_256_steps(pair,
                                                            spec_flags):
    """256+ speculative verify steps with stochastic sampling (partial
    rejections leave allocated span blocks past the accepted prefix)
    across rotating slots under prefix sharing: the pool drains to zero
    live blocks after every round and the leak sweep finds nothing."""
    tgen, _, _ = pair
    st = ServingStats()
    eng = serving.GenerationEngine(tgen, slots=4, paged=True,
                                   kv_block_size=4, prefix_cache=True,
                                   stats=st)
    ps = [repetitive_prompt(9), prompts(128, [7], seed=5)[0],
          repetitive_prompt(12), prompts(128, [10], seed=6)[0]]
    rounds = 0
    while st.counter("spec_steps") < 256 and rounds < 60:
        rounds += 1
        reqs = [GenerationRequest(p, max_new_tokens=8, temperature=0.9,
                                  top_k=8) for p in ps]
        run_bank(eng, reqs, spec_k=4, stats=st)
        assert eng.pool.blocks_in_use() == 0, rounds
    assert st.counter("spec_steps") >= 256
    assert st.counter("spec_rejected") > 0
    assert st.counter("spec_accepted") <= st.counter("spec_drafted")
    assert eng.reclaim_leaks([]) == 0
    assert st.snapshot()["spec_accept_ratio"] == pytest.approx(
        st.counter("spec_accepted") / st.counter("spec_drafted"), abs=1e-4)


def test_spec_server_stats(pair, spec_flags):
    """Through the server: speculative greedy equals spec-off greedy, and
    the acceptance counters and the draft depth ride stats()."""
    tgen, _, _ = pair
    prompt = repetitive_prompt(10)
    set_flags({"decode_spec_k": 4})
    srv = serving.InferenceServer(generator=tgen, decode_slots=2,
                                  paged=True).start(serve_network=False)
    try:
        out = srv.generate(prompt, max_new_tokens=10)
        srv.generate(prompts(128, [7], seed=9)[0], max_new_tokens=8,
                     temperature=0.9, top_k=8)
        stats = srv.stats()
    finally:
        srv.stop()
    np.testing.assert_array_equal(
        out, tgen.generate([prompt], max_new_tokens=10, spec_k=0)[0])
    assert stats["spec_steps"] > 0 and stats["spec_drafted"] > 0
    assert 0.0 <= stats["spec_accept_ratio"] <= 1.0
    assert stats["spec_k"] == 4 and 1 <= stats["spec_k_effective"] <= 4
    assert stats["spec_accept_window"] is not None
    assert stats["kvpool_blocks_in_use"] == 0
