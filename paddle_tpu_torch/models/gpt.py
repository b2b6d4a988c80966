"""GPT-style causal language model: pre-LN decoder blocks with a
weight-tied LM head.

Counterpart of ``paddle_tpu/models/gpt.py``, in two forms over one set
of parameter names (``word_embedding``, ``decoder_layer_{i}_qkv.w_0``,
...):

- Training: :func:`gpt_pretrain` builds the next-token-loss program
  through the Fluid layers, op for op the program the JAX package
  builds; ``fluid.Executor`` runs it. Attention is the ``flash_attention``
  op (causal), whose forward and backward are the CUDA kernels K1-K4.
- Generation programs: :func:`gpt_logits`, :func:`gpt_prefill`,
  :func:`gpt_decode_step`, :func:`gpt_decode_step_paged`,
  :func:`gpt_prefill_chunk_paged`, :func:`gpt_verify_step` and
  :func:`gpt_verify_step_paged` build the JAX package's generation
  programs, with the same feed and fetch names, out of the registered
  decode ops (``layers.nn.kv_cache_write`` ... ``paged_attention``); the
  prefill's causal attention is the ``flash_attention`` op (K1 on the
  card) and the paged decode step's read the ``paged_attention`` op
  (K5). A fed pool is not changed in place: each write op writes a
  clone of it (``ops.decode_ops``).
- Generation module: the same modes as the methods :meth:`GPT.logits`, :meth:`GPT.prefill`,
  :meth:`GPT.decode_step`, :meth:`GPT.decode_step_paged`,
  :meth:`GPT.prefill_chunk_paged`, :meth:`GPT.verify_step` and
  :meth:`GPT.verify_step_paged` of one ``nn.Module``. The full forward
  and prefill run the flash-attention forward kernel (causal), the dense
  decode and verify steps the plain masked read of
  :func:`ops.decode_ops.kv_cached_attention`, the paged decode step the
  paged-attention kernel over the shared block pool, and the paged
  chunk and verify steps (S > 1 queries a row) the gather route
  :func:`kernels.paged_attention.paged_attention_gather`, as the JAX
  package routes them.

Layer norm has eps 1e-5, GELU is the exact erf form, ``fc`` is
``x @ W[in, out] + b`` and the head is ``h @ word_embedding.T``.

Tensor parallelism: :func:`apply_tp_sharding` annotates the training
program (pass ``tp_shard`` carries it out), and the module's tp form
(``GPT(..., tp=)``, what ``GPTGenerator(tp=)`` builds) holds this rank's
shards of the same split (:func:`tp_layouts`): its heads' columns of q,
k and v out of the fused ``qkv``, its rows of ``att_out`` and
``ffn_1``, its columns of ``ffn_0`` and its vocab rows of
``word_embedding``. A layer then takes two all-reduces over the rank's
tp group, the embedding a masked lookup and one, and the logits an
all-gather; the attention kernels run on the rank's ``num_heads / tp``
heads, over a cache of those heads only.
"""
import copy

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from .. import layers
from ..device import resolve_device
from ..framework import initializer as I
from ..kernels.flash_attention import flash_attention
from ..kernels.paged_attention import (paged_attention,
                                      paged_attention_gather)
from ..layers import math as M
from ..layers import tensor as T
from ..ops.decode_ops import (kv_cache_write, kv_cached_attention,
                              paged_kv_cache_write, row_gather)
from ..param_attr import ParamAttr


class GPTConfig:
    def __init__(self, vocab_size=32000, hidden_size=768, num_layers=12,
                 num_heads=12, ffn_size=3072, max_position=2048,
                 dropout=0.1, initializer_range=0.02):
        self.vocab_size = vocab_size
        self.hidden_size = hidden_size
        self.num_layers = num_layers
        self.num_heads = num_heads
        self.ffn_size = ffn_size
        self.max_position = max_position
        self.dropout = dropout
        self.initializer_range = initializer_range

    @property
    def d_head(self):
        return self.hidden_size // self.num_heads

    @classmethod
    def base(cls):
        return cls()

    @classmethod
    def tiny(cls):
        return cls(vocab_size=128, hidden_size=32, num_layers=1,
                   num_heads=2, ffn_size=64, max_position=64, dropout=0.0)


# ---- training program (the JAX package's static-graph builder) ----------

def _param(cfg, name):
    return ParamAttr(name=name,
                     initializer=I.Normal(0.0, cfg.initializer_range))


def _fc_layer(cfg, x, size, name, act=None):
    return layers.fc(x, size, num_flatten_dims=2, act=act,
                     param_attr=_param(cfg, f"{name}.w_0"),
                     bias_attr=ParamAttr(name=f"{name}.b_0",
                                         initializer=I.Constant(0.0)))


def _ln_layer(cfg, x, name, begin_axis=2):
    return layers.layer_norm(
        x, begin_norm_axis=begin_axis,
        param_attr=ParamAttr(name=f"{name}_scale",
                             initializer=I.Constant(1.0)),
        bias_attr=ParamAttr(name=f"{name}_bias",
                            initializer=I.Constant(0.0)))


def decoder_layer(cfg, x, idx, is_test, kv_cache=None, pos=None):
    """Pre-LN block: x + attn(LN(x)); x + ffn(LN(x)). Attention by
    ``kv_cache``, as in the JAX package:

    - None: causal flash attention over the full sequence;
    - ``{"k", "v", "mode": "prefill"}`` with ``pos`` [B]: the fresh k/v
      written into the dense caches at ``pos`` and attended by causal
      flash attention; returns ``(x, k_cache, v_cache)``;
    - ``mode: "decode"``: the fresh k/v written at ``pos`` and the
      queries attending over the cache by position; returns ``(x,
      k_cache, v_cache)``;
    - ``mode: "paged"`` with ``tables`` [B, nblk] (and ``limit`` [B],
      ``k_scale``/``v_scale`` for int8): the write into the block pools
      and the ``paged_attention`` read; returns ``(x, k_pool, v_pool[,
      k_scale, v_scale])``."""
    h = cfg.hidden_size
    n_head, d_head = cfg.num_heads, cfg.hidden_size // cfg.num_heads
    pre = f"decoder_layer_{idx}"

    a = _ln_layer(cfg, x, f"{pre}_pre_att_ln")
    qkv = _fc_layer(cfg, a, 3 * h, f"{pre}_qkv")
    q = T.slice(qkv, axes=[2], starts=[0], ends=[h])
    k = T.slice(qkv, axes=[2], starts=[h], ends=[2 * h])
    v = T.slice(qkv, axes=[2], starts=[2 * h], ends=[3 * h])
    q = T.transpose(T.reshape(q, [0, 0, n_head, d_head]), [0, 2, 1, 3])
    k = T.transpose(T.reshape(k, [0, 0, n_head, d_head]), [0, 2, 1, 3])
    v = T.transpose(T.reshape(v, [0, 0, n_head, d_head]), [0, 2, 1, 3])
    caches = ()
    mode = None if kv_cache is None else kv_cache.get("mode", "decode")
    if mode is None:
        ctx = layers.nn.flash_attention(q, k, v, causal=True)
    elif mode == "paged":
        tables, limit = kv_cache["tables"], kv_cache.get("limit")
        k_sc, v_sc = kv_cache.get("k_scale"), kv_cache.get("v_scale")
        new_k = layers.nn.paged_kv_cache_write(
            kv_cache["k"], k, tables, pos, scale=k_sc, limit=limit)
        new_v = layers.nn.paged_kv_cache_write(
            kv_cache["v"], v, tables, pos, scale=v_sc, limit=limit)
        new_ks = new_vs = None
        if k_sc is not None:
            (new_k, new_ks), (new_v, new_vs) = new_k, new_v
        ctx = layers.nn.paged_attention(q, new_k, new_v, tables, pos,
                                        k_scale=new_ks, v_scale=new_vs)
        caches = (new_k, new_v) + ((new_ks, new_vs) if k_sc is not None
                                   else ())
    else:
        new_k = layers.nn.kv_cache_write(kv_cache["k"], k, pos)
        new_v = layers.nn.kv_cache_write(kv_cache["v"], v, pos)
        if mode == "prefill":
            ctx = layers.nn.flash_attention(q, k, v, causal=True)
        else:
            ctx = layers.nn.kv_cached_attention(q, new_k, new_v, pos)
        caches = (new_k, new_v)
    ctx = T.reshape(T.transpose(ctx, [0, 2, 1, 3]), [0, 0, h])
    attn_out = _fc_layer(cfg, ctx, h, f"{pre}_att_out")
    attn_out = layers.dropout(attn_out, cfg.dropout, is_test=is_test,
                              dropout_implementation="upscale_in_train")
    x = M.elementwise_add(x, attn_out)

    f = _ln_layer(cfg, x, f"{pre}_pre_ffn_ln")
    ffn = _fc_layer(cfg, f, cfg.ffn_size, f"{pre}_ffn_0", act="gelu")
    ffn = _fc_layer(cfg, ffn, h, f"{pre}_ffn_1")
    ffn = layers.dropout(ffn, cfg.dropout, is_test=is_test,
                         dropout_implementation="upscale_in_train")
    out = M.elementwise_add(x, ffn)
    return out if kv_cache is None else (out,) + caches


def gpt_pretrain(cfg, batch_size, seq_len, is_test=False):
    """Feeds -> next-token LM loss, built into the current default
    programs. tokens [B, S] predict tokens[:, 1:] (the final position is
    trained against the padded label). Returns ``{"feeds", "loss",
    "checkpoints"}``."""
    tokens = T.data("tokens", [batch_size, seq_len], dtype="int32")
    labels = T.data("labels", [batch_size, seq_len], dtype="int32")
    loss_mask = T.data("loss_mask", [batch_size, seq_len],
                       dtype="float32")
    pos_ids = T.data("pos_ids", [batch_size, seq_len], dtype="int32")

    emb = layers.embedding(tokens, size=[cfg.vocab_size, cfg.hidden_size],
                           param_attr=_param(cfg, "word_embedding"))
    pos = layers.embedding(pos_ids, size=[cfg.max_position,
                                          cfg.hidden_size],
                           param_attr=_param(cfg, "pos_embedding"))
    x = M.elementwise_add(emb, pos)
    x = layers.dropout(x, cfg.dropout, is_test=is_test,
                       dropout_implementation="upscale_in_train")
    checkpoints = []
    for i in range(cfg.num_layers):
        x = decoder_layer(cfg, x, i, is_test)
        checkpoints.append(x)
    x = _ln_layer(cfg, x, "final_ln")

    # weight-tied LM head over every position
    word_emb = x.block.program.global_block().var("word_embedding")
    flat = T.reshape(x, [-1, cfg.hidden_size])               # [B*S, H]
    logits = layers.matmul(flat, word_emb, transpose_y=True)  # [B*S, V]
    ce = layers.softmax_with_cross_entropy(
        logits, T.reshape(labels, [-1, 1]))
    w = T.reshape(loss_mask, [-1, 1])
    loss = M.elementwise_div(
        M.reduce_sum(M.elementwise_mul(ce, w)),
        M.elementwise_add(M.reduce_sum(w),
                          T.fill_constant([1], "float32", 1e-9)))
    return {"feeds": [tokens, labels, loss_mask, pos_ids],
            "loss": loss, "checkpoints": checkpoints}


def apply_tp_sharding(program, cfg):
    """The Megatron split of :func:`bert.apply_tp_sharding` over ``tp``:
    QKV and FFN-in on the output dim, attention-out and FFN-out on the
    input dim, the word embedding (and the tied head) on the vocab. Call
    before ``minimize``, so the optimizer state takes the split too."""
    from ..parallel.mesh import set_param_dist_attr as _set
    for i in range(cfg.num_layers):
        pre = f"decoder_layer_{i}"
        _set(program, f"{pre}_qkv.w_0", (None, "tp"))
        _set(program, f"{pre}_qkv.b_0", ("tp",))
        _set(program, f"{pre}_att_out.w_0", ("tp", None))
        _set(program, f"{pre}_ffn_0.w_0", (None, "tp"))
        _set(program, f"{pre}_ffn_0.b_0", ("tp",))
        _set(program, f"{pre}_ffn_1.w_0", ("tp", None))
    _set(program, "word_embedding", ("tp", None))


def random_batch(cfg, batch_size, seq_len, rng=None):
    """A random next-token batch (numpy feeds of :func:`gpt_pretrain`)."""
    rng = rng or np.random.default_rng()
    toks = rng.integers(0, cfg.vocab_size,
                        (batch_size, seq_len + 1)).astype(np.int32)
    return {
        "tokens": toks[:, :-1].copy(),
        "labels": toks[:, 1:].copy(),
        "loss_mask": np.ones((batch_size, seq_len), np.float32),
        "pos_ids": np.broadcast_to(
            np.arange(seq_len, dtype=np.int32),
            (batch_size, seq_len)).copy(),
    }


# ---- generation programs (the JAX package's inference graphs) -------------

def _embed_layer(cfg, tokens, pos_ids):
    emb = layers.embedding(tokens, size=[cfg.vocab_size, cfg.hidden_size],
                           param_attr=_param(cfg, "word_embedding"))
    pos = layers.embedding(pos_ids, size=[cfg.max_position,
                                          cfg.hidden_size],
                           param_attr=_param(cfg, "pos_embedding"))
    return M.elementwise_add(emb, pos)


def _tied_next_logits(cfg, x, last_pos):
    """final-LN hidden [B, S, H] -> logits [B, V] at each row's
    ``last_pos`` (the tied head)."""
    x = _ln_layer(cfg, x, "final_ln")
    h = layers.nn.row_gather(x, last_pos)                    # [B, H]
    word_emb = x.block.program.global_block().var("word_embedding")
    return layers.matmul(h, word_emb, transpose_y=True)      # [B, V]


def _tied_span_logits(cfg, x):
    """final-LN hidden [B, S, H] -> logits [B, S, V] at every position."""
    x = _ln_layer(cfg, x, "final_ln")
    word_emb = x.block.program.global_block().var("word_embedding")
    return layers.matmul(x, word_emb, transpose_y=True)      # [B, S, V]


def gpt_logits(cfg, batch_size=-1, seq_len=-1):
    """Full causal forward, no KV cache. Feeds: tokens [B, S], pos_ids
    [B, S], last_pos [B] (int32). Fetch: logits [B, V]."""
    tokens = T.data("tokens", [batch_size, seq_len], dtype="int32")
    pos_ids = T.data("pos_ids", [batch_size, seq_len], dtype="int32")
    last_pos = T.data("last_pos", [batch_size], dtype="int32")
    x = _embed_layer(cfg, tokens, pos_ids)
    for i in range(cfg.num_layers):
        x = decoder_layer(cfg, x, i, True)
    return {"feed_names": ["tokens", "pos_ids", "last_pos"],
            "logits": _tied_next_logits(cfg, x, last_pos)}


def gpt_prefill(cfg, max_len, batch_size=-1, seq_len=-1):
    """Prompt ingestion: the causal forward over the prompt that also
    makes every layer's dense ``[B, H, max_len, D]`` caches (zeros, the
    prompt's k/v written at position 0). Feeds as :func:`gpt_logits`;
    fetches ``logits`` [B, V] and ``cache_k``/``cache_v``."""
    tokens = T.data("tokens", [batch_size, seq_len], dtype="int32")
    pos_ids = T.data("pos_ids", [batch_size, seq_len], dtype="int32")
    last_pos = T.data("last_pos", [batch_size], dtype="int32")
    x = _embed_layer(cfg, tokens, pos_ids)
    n_head, d_head = cfg.num_heads, cfg.hidden_size // cfg.num_heads
    zero_pos = T.fill_constant_batch_size_like(tokens, [-1], "int32", 0)
    cache_k, cache_v = [], []
    for i in range(cfg.num_layers):
        zk = T.fill_constant_batch_size_like(
            tokens, [-1, n_head, max_len, d_head], "float32", 0.0)
        zv = T.fill_constant_batch_size_like(
            tokens, [-1, n_head, max_len, d_head], "float32", 0.0)
        x, ck, cv = decoder_layer(
            cfg, x, i, True,
            kv_cache={"k": zk, "v": zv, "mode": "prefill"}, pos=zero_pos)
        cache_k.append(ck)
        cache_v.append(cv)
    return {"feed_names": ["tokens", "pos_ids", "last_pos"],
            "logits": _tied_next_logits(cfg, x, last_pos),
            "cache_k": cache_k, "cache_v": cache_v}


def _dense_step(cfg, max_len, batch_size, x, pos, feed_names):
    """The decoder layers over fed dense caches ``cache_k_<i>`` /
    ``cache_v_<i>``; returns (x, cache_k, cache_v)."""
    n_head, d_head = cfg.num_heads, cfg.hidden_size // cfg.num_heads
    cache_k, cache_v = [], []
    for i in range(cfg.num_layers):
        ck_in = T.data(f"cache_k_{i}", [batch_size, n_head, max_len, d_head])
        cv_in = T.data(f"cache_v_{i}", [batch_size, n_head, max_len, d_head])
        feed_names += [f"cache_k_{i}", f"cache_v_{i}"]
        x, ck, cv = decoder_layer(
            cfg, x, i, True,
            kv_cache={"k": ck_in, "v": cv_in, "mode": "decode"}, pos=pos)
        cache_k.append(ck)
        cache_v.append(cv)
    return x, cache_k, cache_v


def gpt_decode_step(cfg, max_len, batch_size=-1):
    """One incremental step over the dense caches. Feeds: token [B], pos
    [B] (int32), cache_k_<i>/cache_v_<i> [B, H, max_len, D]. Fetches:
    logits [B, V] and the updated caches."""
    token = T.data("token", [batch_size], dtype="int32")
    pos = T.data("pos", [batch_size], dtype="int32")
    x = T.reshape(_embed_layer(cfg, token, pos), [-1, 1, cfg.hidden_size])
    feed_names = ["token", "pos"]
    x, cache_k, cache_v = _dense_step(cfg, max_len, batch_size, x, pos,
                                      feed_names)
    zero = T.fill_constant_batch_size_like(token, [-1], "int32", 0)
    return {"feed_names": feed_names,
            "logits": _tied_next_logits(cfg, x, zero),
            "cache_k": cache_k, "cache_v": cache_v}


def _paged_step(cfg, kv_dtype, x, tables, pos, feed_names, limit=None):
    """The decoder layers over the fed block pools ``cache_pk_<i>`` /
    ``cache_pv_<i>`` (+ ``cache_pks_<i>``/``cache_pvs_<i>`` for int8);
    returns (x, cache_names, cache_vars) in ``pool_feed_names`` order."""
    from ..serving.kvpool import pool_feed_names
    quantized = kv_dtype == "int8"
    cache_dt = {"fp32": "float32", "bf16": "bfloat16",
                "int8": "int8"}[kv_dtype]
    n_head, d_head = cfg.num_heads, cfg.hidden_size // cfg.num_heads
    by_name = {}
    for i in range(cfg.num_layers):
        names = [f"cache_pk_{i}", f"cache_pv_{i}"]
        kv_cache = {"mode": "paged", "tables": tables, "limit": limit,
                    "k": T.data(names[0], [-1, n_head, -1, d_head],
                                dtype=cache_dt),
                    "v": T.data(names[1], [-1, n_head, -1, d_head],
                                dtype=cache_dt)}
        if quantized:
            names += [f"cache_pks_{i}", f"cache_pvs_{i}"]
            kv_cache["k_scale"] = T.data(names[2], [-1, n_head, -1],
                                         dtype="float32")
            kv_cache["v_scale"] = T.data(names[3], [-1, n_head, -1],
                                         dtype="float32")
        feed_names += names
        x, *outs = decoder_layer(cfg, x, i, True, kv_cache=kv_cache,
                                 pos=pos)
        by_name.update(zip(names, outs))
    cache_names = pool_feed_names(cfg.num_layers, quantized)
    return x, cache_names, [by_name[n] for n in cache_names]


def gpt_decode_step_paged(cfg, kv_dtype="fp32", batch_size=-1):
    """One incremental step over the shared block pools
    (``serving.kvpool``), read by the ``paged_attention`` op. Feeds:
    token [B], pos [B], block_tables [B, nblk] (int32), then the pools.
    Fetches: logits [B, V], then the updated pools in
    ``pool_feed_names`` order (``cache_names``)."""
    token = T.data("token", [batch_size], dtype="int32")
    pos = T.data("pos", [batch_size], dtype="int32")
    tables = T.data("block_tables", [batch_size, -1], dtype="int32")
    x = T.reshape(_embed_layer(cfg, token, pos), [-1, 1, cfg.hidden_size])
    feed_names = ["token", "pos", "block_tables"]
    x, cache_names, cache_vars = _paged_step(cfg, kv_dtype, x, tables, pos,
                                             feed_names)
    zero = T.fill_constant_batch_size_like(token, [-1], "int32", 0)
    return {"feed_names": feed_names,
            "logits": _tied_next_logits(cfg, x, zero),
            "cache_names": cache_names, "cache_vars": cache_vars}


def _paged_span(cfg, kv_dtype, batch_size, span_len, extra_feeds):
    """The shared body of the chunk and verify programs: tokens/pos_ids
    [B, S], start_pos, limit (and ``extra_feeds``) [B], block_tables,
    then the pools."""
    tokens = T.data("tokens", [batch_size, span_len], dtype="int32")
    pos_ids = T.data("pos_ids", [batch_size, span_len], dtype="int32")
    start_pos = T.data("start_pos", [batch_size], dtype="int32")
    limit = T.data("limit", [batch_size], dtype="int32")
    extra = [T.data(n, [batch_size], dtype="int32") for n in extra_feeds]
    tables = T.data("block_tables", [batch_size, -1], dtype="int32")
    x = _embed_layer(cfg, tokens, pos_ids)
    feed_names = ["tokens", "pos_ids", "start_pos", "limit"] \
        + list(extra_feeds) + ["block_tables"]
    x, cache_names, cache_vars = _paged_step(
        cfg, kv_dtype, x, tables, start_pos, feed_names, limit=limit)
    return x, extra, feed_names, cache_names, cache_vars


def gpt_prefill_chunk_paged(cfg, kv_dtype="fp32", batch_size=-1,
                            chunk_len=-1):
    """One chunk of incremental paged prefill: up to C prompt tokens a row
    into the block pools at ``start_pos`` (``limit`` real ones), each
    query attending over what its row holds (the gather route). Feeds:
    tokens, pos_ids [B, C], start_pos, limit, last_idx [B],
    block_tables, then the pools. Fetches: logits [B, V] at
    ``last_idx``, then the updated pools."""
    x, (last_idx,), feed_names, cache_names, cache_vars = _paged_span(
        cfg, kv_dtype, batch_size, chunk_len, ["last_idx"])
    return {"feed_names": feed_names,
            "logits": _tied_next_logits(cfg, x, last_idx),
            "cache_names": cache_names, "cache_vars": cache_vars}


def gpt_verify_step(cfg, max_len, batch_size=-1, span_len=-1):
    """One speculative verify step over the dense caches: S = K+1 fed
    tokens a row written at ``pos[b]..`` and scored in one pass (query i
    sees keys ``<= pos[b] + i``). Feeds: tokens [B, S], pos [B], pos_ids
    [B, S], then the caches. Fetches: logits [B, S, V] and the caches."""
    tokens = T.data("tokens", [batch_size, span_len], dtype="int32")
    pos = T.data("pos", [batch_size], dtype="int32")
    pos_ids = T.data("pos_ids", [batch_size, span_len], dtype="int32")
    x = _embed_layer(cfg, tokens, pos_ids)
    feed_names = ["tokens", "pos", "pos_ids"]
    x, cache_k, cache_v = _dense_step(cfg, max_len, batch_size, x, pos,
                                      feed_names)
    return {"feed_names": feed_names, "logits": _tied_span_logits(cfg, x),
            "cache_k": cache_k, "cache_v": cache_v}


def gpt_verify_step_paged(cfg, kv_dtype="fp32", batch_size=-1,
                          span_len=-1):
    """One speculative verify step over the block pools: the chunk
    program with logits [B, S, V] at every position (``limit``: each
    row's drafts + 1). Feeds: tokens, pos_ids [B, S], start_pos, limit
    [B], block_tables, then the pools."""
    x, _, feed_names, cache_names, cache_vars = _paged_span(
        cfg, kv_dtype, batch_size, span_len, [])
    return {"feed_names": feed_names, "logits": _tied_span_logits(cfg, x),
            "cache_names": cache_names, "cache_vars": cache_vars}


# ---- generation module ----------------------------------------------------

def param_shapes(cfg):
    """{JAX scope name: shape} of every parameter, in build order."""
    h, f = cfg.hidden_size, cfg.ffn_size
    shapes = {"word_embedding": (cfg.vocab_size, h),
              "pos_embedding": (cfg.max_position, h)}
    for i in range(cfg.num_layers):
        pre = f"decoder_layer_{i}"
        for name, (fin, fout) in (("qkv", (h, 3 * h)), ("att_out", (h, h)),
                                  ("ffn_0", (h, f)), ("ffn_1", (f, h))):
            shapes[f"{pre}_{name}.w_0"] = (fin, fout)
            shapes[f"{pre}_{name}.b_0"] = (fout,)
        for ln in ("pre_att_ln", "pre_ffn_ln"):
            shapes[f"{pre}_{ln}_scale"] = (h,)
            shapes[f"{pre}_{ln}_bias"] = (h,)
    shapes["final_ln_scale"] = (h,)
    shapes["final_ln_bias"] = (h,)
    return shapes


def params_from_jax(cfg, arrays):
    """``{JAX scope name: array}`` -> ``{name: float32 CPU tensor}``,
    checked against :func:`param_shapes`: raises on a missing, extra or
    mis-shaped name."""
    want = param_shapes(cfg)
    missing = sorted(set(want) - set(arrays))
    extra = sorted(set(arrays) - set(want))
    if missing or extra:
        raise ValueError(f"GPT parameters do not match the config: "
                         f"missing {missing}, unexpected {extra}")
    out = {}
    for name, shape in want.items():
        a = arrays[name]
        t = a.detach().to(torch.float32, copy=True) \
            if isinstance(a, torch.Tensor) \
            else torch.from_numpy(np.array(a, dtype=np.float32))
        if tuple(t.shape) != shape:
            raise ValueError(f"GPT parameter {name!r} has shape "
                             f"{tuple(t.shape)}, expected {shape}")
        out[name] = t
    return out


def init_params(cfg, seed=0):
    """Seeded random parameters with the JAX startup's initializers:
    ``Normal(0, initializer_range)`` weights and embeddings, zero biases,
    unit layer-norm scales. Float32 CPU tensors."""
    gen = torch.Generator().manual_seed(int(seed))
    out = {}
    for name, shape in param_shapes(cfg).items():
        if name.endswith("_scale"):
            out[name] = torch.ones(shape)
        elif name.endswith("_bias") or name.endswith(".b_0"):
            out[name] = torch.zeros(shape)
        else:
            out[name] = torch.empty(shape).normal_(
                0.0, cfg.initializer_range, generator=gen)
    return out


def tp_layouts(cfg):
    """``{name: parallel.tp.Layout}`` of the Megatron split of
    :func:`apply_tp_sharding`: ``qkv`` split piece by piece (q, k, v)."""
    from ..parallel.tp import Layout
    h, f = cfg.hidden_size, cfg.ffn_size
    out = {"word_embedding": Layout(0, 1, (cfg.vocab_size, h))}
    for i in range(cfg.num_layers):
        pre = f"decoder_layer_{i}"
        out[f"{pre}_qkv.w_0"] = Layout(1, 3, (h, 3 * h))
        out[f"{pre}_qkv.b_0"] = Layout(0, 3, (3 * h,))
        out[f"{pre}_att_out.w_0"] = Layout(0, 1, (h, h))
        out[f"{pre}_ffn_0.w_0"] = Layout(1, 1, (h, f))
        out[f"{pre}_ffn_0.b_0"] = Layout(0, 1, (f,))
        out[f"{pre}_ffn_1.w_0"] = Layout(0, 1, (f, h))
    return out


def _attr(name):
    return name.replace(".", "__")


class GPT(nn.Module):
    """Inference GPT over ``params`` (``{JAX scope name: tensor}``, whole)
    on ``device`` (None -> CUDA; raises without a GPU). With ``tp`` > 1
    it holds this rank's shards of :func:`tp_layouts` on the tp axis of
    ``mesh`` (default ``parallel.mesh.make_mesh(tp=tp)``), runs its
    ``num_heads / tp`` heads and sums or gathers over that axis of that
    mesh wherever the split asks for it."""

    def __init__(self, cfg, params, device=None, tp=1, mesh=None):
        super().__init__()
        self.cfg = cfg
        self.device = resolve_device(device)
        self.tp = int(tp or 1)
        self.mesh, self.tp_rank, self.layouts = None, 0, {}
        if self.tp > 1:
            from ..parallel.mesh import MeshConfig, make_mesh
            self.mesh = mesh or make_mesh(MeshConfig(tp=self.tp))
            self.tp_rank = self.mesh.coords()["tp"]
            self.layouts = tp_layouts(cfg)
        self.heads = cfg.num_heads // self.tp
        self.step_wire = 0          # bytes the last step's collectives moved
        params = params_from_jax(cfg, params)
        for name, t in params.items():
            self.register_parameter(_attr(name), nn.Parameter(
                self.shard(name, t).to(self.device), requires_grad=False))

    def shard(self, name, t):
        """This rank's shard of the whole parameter ``t`` (``t`` itself
        when the name is not split)."""
        lay = self.layouts.get(name)
        if lay is None:
            return t
        from ..parallel.tp import shard_tensor
        return shard_tensor(t, lay, self.tp, self.tp_rank)

    def _tp_sum(self, x):
        """The sum of the tp ranks' partial ``x`` (in place)."""
        if self.tp == 1:
            return x
        from ..ops.collective_ops import all_reduce
        self.step_wire += x.numel() * x.element_size()
        return all_reduce(x.contiguous(), "sum", "tp", mesh=self.mesh)

    def _tp_gather(self, x):
        """The tp ranks' vocab columns ``x`` [..., V/tp] gathered."""
        if self.tp == 1:
            return x
        from ..ops.collective_ops import all_gather
        out = all_gather(x, "tp", x.dim() - 1, mesh=self.mesh)
        self.step_wire += out.numel() * out.element_size()
        return out

    def param(self, name):
        """Parameter by its JAX scope name."""
        return getattr(self, _attr(name))

    def truncated(self, num_layers):
        """A GPT of the first ``num_layers`` decoder layers over the SAME
        parameter tensors (embeddings, those layers, the final norm): the
        model drafter's draft model, with no second copy of the weights."""
        cfg = copy.copy(self.cfg)
        cfg.num_layers = max(1, min(int(num_layers), self.cfg.num_layers))
        small = GPT.__new__(GPT)
        nn.Module.__init__(small)
        small.cfg = cfg
        small.device = self.device
        for k in ("tp", "mesh", "layouts", "tp_rank", "heads", "step_wire"):
            setattr(small, k, getattr(self, k))
        for name in param_shapes(cfg):
            small.register_parameter(_attr(name), self.param(name))
        return small

    def gathered_truncated(self, num_layers):
        """A tp-1 GPT of the first ``num_layers`` decoder layers over whole
        copies of their parameters, gathered once from the shards over
        the tp axis (every rank of the group calls it, in one order)."""
        from ..parallel.tp import gather_tensor
        cfg = copy.copy(self.cfg)
        cfg.num_layers = max(1, min(int(num_layers), self.cfg.num_layers))
        whole = {}
        for name in param_shapes(cfg):
            t = self.param(name)
            lay = self.layouts.get(name)
            whole[name] = t if lay is None else gather_tensor(
                t.detach(), lay, self.mesh)
        return GPT(cfg, whole, device=self.device)

    # -- pieces -----------------------------------------------------------
    def _embed(self, tokens, pos_ids):
        self.step_wire = 0
        w = self.param("word_embedding")
        if self.tp > 1:
            # the rank's vocab rows, then the ranks' lookups summed
            from ..ops.collective_ops import vocab_lookup
            e = self._tp_sum(vocab_lookup(tokens, w,
                                          self.tp_rank * w.shape[0]))
        else:
            e = F.embedding(tokens, w)
        return e + F.embedding(pos_ids, self.param("pos_embedding"))

    def _ln(self, x, name):
        return F.layer_norm(x, (self.cfg.hidden_size,),
                            self.param(f"{name}_scale"),
                            self.param(f"{name}_bias"), eps=1e-5)

    def _fc(self, x, name):
        y = torch.matmul(x, self.param(f"{name}.w_0"))
        lay = self.layouts.get(f"{name}.w_0")
        if lay is not None and lay.dim == 0:     # row split: partial sums
            y = self._tp_sum(y)
        return y + self.param(f"{name}.b_0")

    def _layer(self, i, x, attend):
        """Pre-LN block: x + attn(LN(x)); x + ffn(LN(x)). ``attend(q, k,
        v)`` takes and returns ``[B, H, S, D]`` (the rank's heads)."""
        cfg = self.cfg
        B, S, _ = x.shape
        hl = self.heads * cfg.d_head
        pre = f"decoder_layer_{i}"
        qkv = self._fc(self._ln(x, f"{pre}_pre_att_ln"), f"{pre}_qkv")
        q, k, v = (t.view(B, S, self.heads, cfg.d_head).transpose(1, 2)
                   for t in qkv.split(hl, dim=-1))
        ctx = attend(q, k, v).transpose(1, 2).reshape(B, S, hl)
        x = x + self._fc(ctx, f"{pre}_att_out")
        f = self._ln(x, f"{pre}_pre_ffn_ln")
        f = F.gelu(self._fc(f, f"{pre}_ffn_0"), approximate="none")
        return x + self._fc(f, f"{pre}_ffn_1")

    def _next_logits(self, x, last_pos):
        """final-LN hidden [B, S, H] -> logits [B, V] at each row's
        ``last_pos`` (tied head)."""
        h = row_gather(self._ln(x, "final_ln"), last_pos)
        return self._tp_gather(torch.matmul(
            h, self.param("word_embedding").t()))

    def _span_logits(self, x):
        """final-LN hidden [B, S, H] -> logits [B, S, V] at EVERY position
        (the verify step scores all K+1 speculative positions)."""
        return self._tp_gather(torch.matmul(
            self._ln(x, "final_ln"), self.param("word_embedding").t()))

    def _paged_attend(self, pools, tables, start_pos, limit, i):
        """``attend`` of layer ``i`` over the block pool for S >= 1 fresh
        queries a row at ``start_pos``: write the ``limit`` real keys and
        values (the rest go to the trash block), then read through the
        gather route."""
        pk, pv, pks, pvs = pools[i]

        def attend(q, k, v):
            paged_kv_cache_write(pk, k, tables, start_pos, scale=pks,
                                 limit=limit)
            paged_kv_cache_write(pv, v, tables, start_pos, scale=pvs,
                                 limit=limit)
            return paged_attention_gather(q, pk, pv, tables, start_pos,
                                          k_scale=pks, v_scale=pvs)
        return attend

    # -- entry points -----------------------------------------------------
    @torch.no_grad()
    def logits(self, tokens, pos_ids, last_pos):
        """Full causal forward, no KV cache (``gpt_logits``): the naive
        generation baseline. tokens/pos_ids ``[B, S]``, last_pos ``[B]``
        -> logits ``[B, V]`` at each row's last real position."""
        x = self._embed(tokens, pos_ids)
        for i in range(self.cfg.num_layers):
            x = self._layer(i, x, lambda q, k, v: flash_attention(
                q, k, v, causal=True))
        return self._next_logits(x, last_pos)

    @torch.no_grad()
    def prefill(self, tokens, pos_ids, last_pos):
        """Causal forward over a right-padded prompt batch. tokens/pos_ids
        ``[B, S]``, last_pos ``[B]`` -> ``(logits [B, V], ks, vs)`` with
        ``ks[i]``/``vs[i]`` the layer's fresh keys/values ``[B, H, S, D]``
        (position 0 onward; padded positions hold garbage that position
        masks never read)."""
        x = self._embed(tokens, pos_ids)
        ks, vs = [], []

        def attend(q, k, v):
            ks.append(k)
            vs.append(v)
            return flash_attention(q, k, v, causal=True)

        for i in range(self.cfg.num_layers):
            x = self._layer(i, x, attend)
        return self._next_logits(x, last_pos), ks, vs

    @torch.no_grad()
    def decode_step(self, token, pos, cache_k, cache_v):
        """One incremental step over the dense bank: token/pos ``[B]``,
        ``cache_k[i]``/``cache_v[i]`` ``[B, H, L, D]`` (updated in place
        at ``pos``) -> logits ``[B, V]``."""
        x = self._embed(token[:, None], pos[:, None])
        for i in range(self.cfg.num_layers):
            def attend(q, k, v, i=i):
                kv_cache_write(cache_k[i], k, pos)
                kv_cache_write(cache_v[i], v, pos)
                return kv_cached_attention(q, cache_k[i], cache_v[i], pos)
            x = self._layer(i, x, attend)
        return self._next_logits(x, torch.zeros_like(pos))

    @torch.no_grad()
    def decode_step_paged(self, token, pos, tables, pools):
        """One incremental step over the shared block pool: token/pos
        ``[B]`` int, tables ``[B, nblk]`` int32, ``pools[i]`` the layer's
        ``(k_pool, v_pool, k_scale, v_scale)`` (scales None unless int8;
        updated in place) -> logits ``[B, V]``."""
        pos32 = pos.to(torch.int32)
        x = self._embed(token[:, None], pos[:, None])
        for i in range(self.cfg.num_layers):
            pk, pv, pks, pvs = pools[i]

            def attend(q, k, v, pk=pk, pv=pv, pks=pks, pvs=pvs):
                paged_kv_cache_write(pk, k, tables, pos, scale=pks)
                paged_kv_cache_write(pv, v, tables, pos, scale=pvs)
                return paged_attention(q.contiguous(), pk, pv, tables,
                                       pos32, k_scale=pks, v_scale=pvs)
            x = self._layer(i, x, attend)
        return self._next_logits(x, torch.zeros_like(pos))

    @torch.no_grad()
    def prefill_chunk_paged(self, tokens, pos_ids, start_pos, limit,
                            last_idx, tables, pools):
        """One chunk of incremental paged prefill
        (``gpt_prefill_chunk_paged``): up to C prompt tokens a row go
        straight into the block pool at ``start_pos`` (``limit [B]`` real
        ones; the rest to the trash block), each query attending over
        everything its row already holds. tokens/pos_ids ``[B, C]`` ->
        logits ``[B, V]`` at chunk index ``last_idx`` (meaningful only on
        a prompt's final chunk)."""
        x = self._embed(tokens, pos_ids)
        for i in range(self.cfg.num_layers):
            x = self._layer(i, x, self._paged_attend(pools, tables,
                                                     start_pos, limit, i))
        return self._next_logits(x, last_idx)

    @torch.no_grad()
    def verify_step(self, tokens, pos, pos_ids, cache_k, cache_v):
        """Speculative verify over the dense bank (``gpt_verify_step``):
        S = K+1 fed tokens a row (the current token and K drafts) written
        at ``pos[b]..pos[b]+S-1`` and scored in one pass, query i seeing
        keys ``<= pos[b] + i``. -> logits ``[B, S, V]``: position i is what
        a sequential decode step would give after accepting i drafts."""
        x = self._embed(tokens, pos_ids)
        for i in range(self.cfg.num_layers):
            def attend(q, k, v, i=i):
                kv_cache_write(cache_k[i], k, pos)
                kv_cache_write(cache_v[i], v, pos)
                return kv_cached_attention(q, cache_k[i], cache_v[i], pos)
            x = self._layer(i, x, attend)
        return self._span_logits(x)

    @torch.no_grad()
    def verify_step_paged(self, tokens, pos_ids, start_pos, limit, tables,
                          pools):
        """Speculative verify over the block pool
        (``gpt_verify_step_paged``): a chunked-prefill pass that returns
        logits ``[B, S, V]`` at every position; ``limit [B]`` is each
        row's real span (its drafts + 1), the rest writes to the trash
        block."""
        x = self._embed(tokens, pos_ids)
        for i in range(self.cfg.num_layers):
            x = self._layer(i, x, self._paged_attend(pools, tables,
                                                     start_pos, limit, i))
        return self._span_logits(x)
