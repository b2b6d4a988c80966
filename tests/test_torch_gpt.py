"""Port GPT (paddle_tpu_torch.models) against the JAX package on the CPU.

Parameters come from the JAX startup program (its threefry init cannot
be reproduced in torch) and enter the port through ``params_from_jax``.
The same seeded prompts and teacher-forced tokens go through the JAX
programs (gpt_prefill / gpt_decode_step / gpt_decode_step_paged via
``GPTGenerator``'s stage runners, as tests/test_decode.py and
tests/test_kvpool.py drive them) and through the port's ``GPT`` methods.

Tolerance for logits: atol 1e-4, rtol 1e-4 — float32 on both sides, the
differences are the CPU matmul summation order (XLA vs ATen) through a
few layers. Greedy tokens must be equal."""
import jax
import numpy as np
import pytest
import torch

import paddle_tpu as fluid
from paddle_tpu.models import gpt as jgpt
from paddle_tpu.models.generation import GPTGenerator as JGenerator
from paddle_tpu.serving.kvpool import KVBlockPool as JPool
from paddle_tpu_torch.models import (GPTConfig, GPTGenerator, param_shapes,
                                     params_from_jax)
from paddle_tpu_torch.serving.kvpool import KVBlockPool

_ATOL = _RTOL = 1e-4
MAX_LEN, BUCKET_MIN = 48, 8


def _configs():
    tiny = dict(vocab_size=128, hidden_size=32, num_layers=1, num_heads=2,
                ffn_size=64, max_position=64, dropout=0.0)
    return {"tiny": tiny, "tiny2": dict(tiny, num_layers=2)}


@pytest.fixture(scope="module", params=sorted(_configs()))
def pair(request):
    """(port generator, JAX generator, JAX scope arrays) for one config."""
    kw = _configs()[request.param]
    jcfg = jgpt.GPTConfig(**kw)
    main, startup = fluid.Program(), fluid.Program()
    with fluid.program_guard(main, startup):
        jgpt.gpt_logits(jcfg)
    scope = fluid.Scope()
    with fluid.scope_guard(scope):
        fluid.Executor().run(startup)
    arrays = {n: np.asarray(v) for n, v in scope.items()
              if not n.startswith("@")}
    jgen = JGenerator(jcfg, scope, max_len=MAX_LEN, bucket_min=BUCKET_MIN)
    tgen = GPTGenerator(GPTConfig(**kw), arrays, max_len=MAX_LEN,
                        bucket_min=BUCKET_MIN, device="cpu")
    return tgen, jgen, arrays


def _prompts(vocab, lens, seed=3):
    rng = np.random.default_rng(seed)
    return [rng.integers(1, vocab, n).astype(np.int32) for n in lens]


def _close(got, want):
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=_ATOL,
                               rtol=_RTOL)


def test_params_from_jax_checks_names_and_shapes(pair):
    _, _, arrays = pair
    cfg = GPTConfig.tiny()
    params = params_from_jax(cfg, {n: a for n, a in arrays.items()
                                   if n.startswith(("word", "pos", "final",
                                                    "decoder_layer_0"))})
    assert set(params) == set(param_shapes(cfg))
    assert all(t.dtype == torch.float32 for t in params.values())
    with pytest.raises(ValueError, match="missing.*final_ln_scale"):
        params_from_jax(cfg, {n: a for n, a in arrays.items()
                              if n != "final_ln_scale"})
    with pytest.raises(ValueError, match="unexpected.*bogus"):
        params_from_jax(cfg, dict(arrays, bogus=np.zeros(2)))
    bad = dict(arrays)
    bad["word_embedding"] = bad["word_embedding"][:, :-1]
    with pytest.raises(ValueError, match="word_embedding.*shape"):
        params_from_jax(cfg, {n: a for n, a in bad.items()
                              if not n.startswith("decoder_layer_1")})


def test_prefill_logits_and_caches_match_jax(pair):
    tgen, jgen, _ = pair
    prompts = _prompts(tgen.cfg.vocab_size, (5, 9, 12))
    tokens, pos_ids, last = tgen._pack_prompts(prompts)
    want, caches, _ = jgen._run_prefill(tokens, pos_ids, last,
                                        jax.random.PRNGKey(0))
    got, ks, vs = tgen.run_prefill(tokens, pos_ids, last)
    _close(got, want)
    s = tokens.shape[1]
    for i in range(tgen.cfg.num_layers):
        for kind, new in (("k", ks[i]), ("v", vs[i])):
            _close(new.contiguous(),
                   np.asarray(caches[f"cache_{kind}_{i}"])[:, :, :s])


@pytest.mark.parametrize("paged", [False, True])
def test_decode_step_logits_match_jax_teacher_forced(pair, paged):
    """Six decode steps fed the same random tokens on both sides: the
    dense step vs gpt_decode_step, the paged step vs
    gpt_decode_step_paged (fp32 pools)."""
    tgen, jgen, _ = pair
    cfg = tgen.cfg
    prompts = _prompts(cfg.vocab_size, (5, 9, 12), seed=8)
    lens = [p.size for p in prompts]
    B = len(prompts)
    tokens, pos_ids, last = tgen._pack_prompts(prompts)
    bb, s = tokens.shape
    key = jax.random.PRNGKey(0)
    _, jcaches, key = jgen._run_prefill(tokens, pos_ids, last, key)
    _, ks, vs = tgen.run_prefill(tokens, pos_ids, last)
    if paged:
        jpool = JPool(slots=bb, num_layers=cfg.num_layers,
                      num_heads=cfg.num_heads, d_head=cfg.d_head,
                      max_seq_len=MAX_LEN, block_size=8, dtype="fp32",
                      name="port-parity")
        tpool = KVBlockPool(slots=bb, num_layers=cfg.num_layers,
                            num_heads=cfg.num_heads, d_head=cfg.d_head,
                            max_seq_len=MAX_LEN, block_size=8, dtype="fp32",
                            device="cpu")
        for pool in (jpool, tpool):
            for r in range(B):
                pool.alloc(r, lens[r])
        jpool.scatter_prefill(list(range(B)), jcaches, s)
        tpool.scatter_prefill(list(range(B)), ks, vs, s)
    else:
        cache_k, cache_v = tgen.new_dense_caches(bb)
        for c, new in zip(cache_k + cache_v, ks + vs):
            c[:, :, :s] = new
    rng = np.random.default_rng(5)
    pos = np.zeros((bb,), np.int32)
    pos[:B] = lens
    for _ in range(6):
        tok = rng.integers(1, cfg.vocab_size, bb).astype(np.int32)
        if paged:
            for r in range(B):
                jpool.ensure(r, int(pos[r]))
                tpool.ensure(r, int(pos[r]))
            np.testing.assert_array_equal(tpool.tables, jpool.tables)
            want, key = jgen._run_decode_paged(tok, pos, jpool, key)
            got = tgen.run_decode_paged(tok, pos, tpool)
        else:
            want, jcaches, key = jgen._run_decode(tok, pos, jcaches, key)
            got = tgen.run_decode(tok, pos, cache_k, cache_v)
        # padded rows read the trash block, whose duplicate writes may
        # land in any order: compare the real rows
        _close(got[:B], np.asarray(want)[:B])
        pos[:B] += 1


@pytest.mark.parametrize("paged", [False, True])
def test_greedy_generate_matches_jax_token_for_token(pair, paged):
    tgen, jgen, _ = pair
    prompts = _prompts(tgen.cfg.vocab_size, (5, 9, 12))
    want = jgen.generate(prompts, max_new_tokens=14, seed=0)
    got = tgen.generate(prompts, max_new_tokens=14, seed=0, paged=paged)
    for a, b in zip(got, want):
        assert a.dtype == np.int32 and a.shape == (14,)
        np.testing.assert_array_equal(a, b)


def test_top_k_one_equals_greedy_and_eos_stops(pair):
    tgen, _, _ = pair
    prompts = _prompts(tgen.cfg.vocab_size, (4, 7), seed=9)
    greedy = tgen.generate(prompts, max_new_tokens=10)
    topk1 = tgen.generate(prompts, max_new_tokens=10, temperature=1.0,
                          top_k=1, seed=5)
    for a, b in zip(greedy, topk1):
        np.testing.assert_array_equal(a, b)
    eos = int(greedy[0][3])
    cut = tgen.generate(prompts[:1], max_new_tokens=10, eos_id=eos)[0]
    np.testing.assert_array_equal(cut, greedy[0][:list(greedy[0]).index(eos)])
    # sampling is reproducible from its seed
    s1 = tgen.generate(prompts, max_new_tokens=10, temperature=1.0, seed=7)
    s2 = tgen.generate(prompts, max_new_tokens=10, temperature=1.0, seed=7)
    for a, b in zip(s1, s2):
        np.testing.assert_array_equal(a, b)


def test_generate_rejects_overlong_and_empty_prompts(pair):
    tgen, _, _ = pair
    with pytest.raises(ValueError, match="max_len"):
        tgen.generate([np.ones(40, np.int32)], max_new_tokens=10)
    with pytest.raises(ValueError, match="empty"):
        tgen.generate([np.zeros(0, np.int32)], max_new_tokens=2)
