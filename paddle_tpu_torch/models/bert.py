"""BERT-base pretraining, the flagship model of the JAX package.

Counterpart of ``paddle_tpu/models/bert.py``: :func:`bert_pretrain`
builds the masked-LM + next-sentence program through the Fluid layers,
op for op the program the JAX package builds (post-LN encoder blocks,
the MLM head weight-tied to ``word_embedding``), and ``fluid.Executor``
runs it. Attention is the einsum composite with attention dropout
(``attn_mechanism`` None), the ``flash_attention`` op, non-causal
with a ``[B, 1, 1, S]`` key bias (``"flash"``), whose forward and
backward are the CUDA kernels K1 and K2 (K3 + K4 past 4096 keys), or
the sequence-parallel ``ring_attention``/``ulysses_attention`` ops
(``"ring"``/``"ulysses"``, no attention dropout, as in the JAX model).
:func:`apply_tp_sharding` annotates the Megatron split as the JAX
package does; pass ``tp_shard`` (``CompiledProgram.with_data_parallel``
over a tp mesh) carries it out. ``sp_shard=True`` pins the hidden state
to ``("dp", "sp", None)`` before every block; pass ``sp_shard`` (over a
mesh with an sp axis) splits its sequence dim there.

Every weight, embedding and layer-norm scale starts from
``TruncatedNormal(0, initializer_range)`` (the layer-norm scales too, as
in the JAX model), every bias from zeros.
"""
from dataclasses import dataclass

import numpy as np
import torch

from .. import layers
from ..framework import initializer as I
from ..layers import math as M
from ..layers import tensor as T
from ..layers.collective import shard
from ..param_attr import ParamAttr


@dataclass
class BertConfig:
    vocab_size: int = 30522
    hidden_size: int = 768
    num_layers: int = 12
    num_heads: int = 12
    ffn_size: int = 3072
    max_position: int = 512
    type_vocab_size: int = 2
    hidden_dropout: float = 0.1
    attn_dropout: float = 0.1
    initializer_range: float = 0.02
    # None = the einsum composite; "flash" = the flash_attention op (K1,
    # K2); "ring"/"ulysses" = sequence-parallel attention over "sp"
    attn_mechanism: str = None
    # kept in the flash op for the JAX program form; the kernels pick
    # their own tiles
    flash_block_q: int = None
    flash_block_k: int = None

    @staticmethod
    def base():
        return BertConfig()

    @staticmethod
    def tiny(vocab_size=128, hidden_size=64, num_layers=2, num_heads=4,
             ffn_size=128, max_position=64):
        return BertConfig(vocab_size=vocab_size, hidden_size=hidden_size,
                          num_layers=num_layers, num_heads=num_heads,
                          ffn_size=ffn_size, max_position=max_position)


def _param(cfg, name):
    return ParamAttr(name=name, initializer=I.TruncatedNormal(
        scale=cfg.initializer_range))


def _zero(name):
    return ParamAttr(name=name, initializer=I.Constant(0.0))


def _fc(cfg, x, size, name, act=None, num_flatten_dims=2):
    return layers.fc(x, size, num_flatten_dims=num_flatten_dims,
                     param_attr=_param(cfg, name + ".w_0"),
                     bias_attr=_zero(name + ".b_0"), act=act, name=name)


def _layer_norm(cfg, x, name, begin_norm_axis=2):
    return layers.layer_norm(x, begin_norm_axis=begin_norm_axis,
                             param_attr=_param(cfg, name + "_scale"),
                             bias_attr=_zero(name + "_bias"))


def encoder_layer(cfg, x, attn_bias, idx, is_test):
    """One post-LN transformer block. x: [B, S, H]."""
    h = cfg.hidden_size
    n_head = cfg.num_heads
    d_head = h // n_head
    pre = f"encoder_layer_{idx}"

    qkv = _fc(cfg, x, 3 * h, f"{pre}_multi_head_att_qkv")      # [B,S,3H]
    q = T.slice(qkv, axes=[2], starts=[0], ends=[h])
    k = T.slice(qkv, axes=[2], starts=[h], ends=[2 * h])
    v = T.slice(qkv, axes=[2], starts=[2 * h], ends=[3 * h])
    if cfg.attn_mechanism:
        # the flash and sequence-parallel ops take [B, nH, S, dH]
        q, k, v = (T.transpose(T.reshape(t, [0, 0, n_head, d_head]),
                               [0, 2, 1, 3]) for t in (q, k, v))
        if cfg.attn_mechanism == "flash":
            ctx = layers.nn.flash_attention(q, k, v, attn_bias=attn_bias,
                                            block_q=cfg.flash_block_q,
                                            block_k=cfg.flash_block_k)
        else:
            # the K/V ring or the Ulysses all-to-all over "sp"; exact
            # softmax, no attention dropout
            ctx = layers.nn.ring_attention(q, k, v, attn_bias=attn_bias,
                                           mechanism=cfg.attn_mechanism)
        ctx = T.reshape(T.transpose(ctx, [0, 2, 1, 3]), [0, 0, h])
    else:
        # einsum keeps q/k/v in [B, S, nH, dH]
        q, k, v = (T.reshape(t, [0, 0, n_head, d_head]) for t in (q, k, v))
        scores = M.scale(M.einsum("bsnd,btnd->bnst", q, k),
                         scale=1.0 / float(np.sqrt(d_head)))
        scores = M.elementwise_add(scores, attn_bias)
        probs = layers.softmax(scores)
        probs = layers.dropout(probs, cfg.attn_dropout, is_test=is_test,
                               dropout_implementation="upscale_in_train")
        ctx = M.einsum("bnst,btnd->bsnd", probs, v)           # [B,S,nH,dH]
        ctx = T.reshape(ctx, [0, 0, h])
    attn_out = _fc(cfg, ctx, h, f"{pre}_multi_head_att_output_fc")
    attn_out = layers.dropout(attn_out, cfg.hidden_dropout, is_test=is_test,
                              dropout_implementation="upscale_in_train")
    x = _layer_norm(cfg, M.elementwise_add(x, attn_out),
                    f"{pre}_post_att_layer_norm")

    ffn = _fc(cfg, x, cfg.ffn_size, f"{pre}_ffn_fc_0", act="gelu")
    ffn = _fc(cfg, ffn, h, f"{pre}_ffn_fc_1")
    ffn = layers.dropout(ffn, cfg.hidden_dropout, is_test=is_test,
                         dropout_implementation="upscale_in_train")
    return _layer_norm(cfg, M.elementwise_add(x, ffn),
                       f"{pre}_post_ffn_layer_norm")


def bert_encoder(cfg, src_ids, sent_ids, pos_ids, input_mask, is_test=False,
                 sp_shard=False):
    """Embeddings + N transformer blocks -> ([B, S, H], the blocks'
    outputs). ``sp_shard``: the hidden state pinned to ``("dp", "sp",
    None)`` before every block (sequence-parallel residency)."""
    emb = layers.embedding(src_ids, size=[cfg.vocab_size, cfg.hidden_size],
                           param_attr=_param(cfg, "word_embedding"))
    pos_emb = layers.embedding(pos_ids, size=[cfg.max_position,
                                              cfg.hidden_size],
                               param_attr=_param(cfg, "pos_embedding"))
    sent_emb = layers.embedding(sent_ids, size=[cfg.type_vocab_size,
                                                cfg.hidden_size],
                                param_attr=_param(cfg, "sent_embedding"))
    emb = M.elementwise_add(M.elementwise_add(emb, pos_emb), sent_emb)
    emb = _layer_norm(cfg, emb, "pre_encoder_layer_norm")
    emb = layers.dropout(emb, cfg.hidden_dropout, is_test=is_test,
                         dropout_implementation="upscale_in_train")

    # additive attention bias [B, 1, 1, S]: 0 where attended, -1e4 where
    # masked
    mask = layers.unsqueeze(input_mask, [1, 2])
    attn_bias = M.scale(M.elementwise_sub(mask, T.ones_like(mask)),
                        scale=10000.0)
    x = emb
    checkpoints = []
    for i in range(cfg.num_layers):
        if sp_shard:
            x = shard(x, "dp", "sp", None)
        x = encoder_layer(cfg, x, attn_bias, i, is_test)
        checkpoints.append(x)
    return x, checkpoints


def bert_pretrain(cfg, batch_size, seq_len, max_preds, is_test=False,
                  sp_shard=False):
    """The masked-LM + next-sentence pretraining program (feeds -> loss).
    Returns ``{"feeds", "loss", "mlm_loss", "nsp_acc", "checkpoints"}``."""
    src_ids = T.data("src_ids", [batch_size, seq_len], dtype="int32")
    sent_ids = T.data("sent_ids", [batch_size, seq_len], dtype="int32")
    pos_ids = T.data("pos_ids", [batch_size, seq_len], dtype="int32")
    input_mask = T.data("input_mask", [batch_size, seq_len], dtype="float32")
    mask_pos = T.data("mask_pos", [batch_size * max_preds], dtype="int32")
    mask_label = T.data("mask_label", [batch_size * max_preds, 1],
                        dtype="int32")
    labels = T.data("labels", [batch_size, 1], dtype="int32")

    enc, checkpoints = bert_encoder(cfg, src_ids, sent_ids, pos_ids,
                                    input_mask, is_test=is_test,
                                    sp_shard=sp_shard)          # [B,S,H]

    # masked LM head, weight-tied to word_embedding
    flat = T.reshape(enc, [-1, cfg.hidden_size])               # [B*S, H]
    picked = T.gather(flat, mask_pos)                          # [B*P, H]
    trans = layers.fc(picked, cfg.hidden_size,
                      param_attr=_param(cfg, "mask_lm_trans_fc.w_0"),
                      bias_attr=_zero("mask_lm_trans_fc.b_0"), act="gelu")
    trans = _layer_norm(cfg, trans, "mask_lm_trans_layer_norm",
                        begin_norm_axis=1)
    gblock = trans.block.program.global_block()
    logits = layers.matmul(trans, gblock.var("word_embedding"),
                           transpose_y=True)                   # [B*P, V]
    mlm_bias = gblock.create_parameter(
        name="mask_lm_out_fc.b_0", shape=[cfg.vocab_size], dtype="float32",
        initializer=I.Constant(0.0))
    mlm_bias.initializer(mlm_bias)
    logits = M.elementwise_add(logits, mlm_bias)
    mlm_loss = M.mean(layers.softmax_with_cross_entropy(logits, mask_label))

    # next-sentence head on the first token
    cls = T.slice(enc, axes=[1], starts=[0], ends=[1])         # [B,1,H]
    cls = T.reshape(cls, [-1, cfg.hidden_size])
    pooled = layers.fc(cls, cfg.hidden_size,
                       param_attr=_param(cfg, "pooled_fc.w_0"),
                       bias_attr=_zero("pooled_fc.b_0"), act="tanh")
    nsp_logits = layers.fc(pooled, 2, param_attr=_param(cfg,
                                                        "next_sent_fc.w_0"),
                           bias_attr=_zero("next_sent_fc.b_0"))
    nsp_loss = M.mean(layers.softmax_with_cross_entropy(nsp_logits, labels))
    nsp_acc = layers.accuracy(layers.softmax(nsp_logits), labels)

    loss = M.elementwise_add(mlm_loss, nsp_loss)
    return {"feeds": [src_ids, sent_ids, pos_ids, input_mask, mask_pos,
                      mask_label, labels],
            "loss": loss, "mlm_loss": mlm_loss, "nsp_acc": nsp_acc,
            "checkpoints": checkpoints}


def apply_tp_sharding(program, cfg):
    """Annotate the encoder weights for Megatron tensor parallelism over
    ``tp``, as the JAX package does: QKV and FFN-in split on the output
    dim, attention-out and FFN-out on the input dim, the word embedding
    (and the tied MLM head) on the vocab. Call before ``minimize``, so
    the optimizer state takes the split too."""
    from ..parallel.mesh import set_param_dist_attr as _set
    for i in range(cfg.num_layers):
        pre = f"encoder_layer_{i}"
        _set(program, f"{pre}_multi_head_att_qkv.w_0", (None, "tp"))
        _set(program, f"{pre}_multi_head_att_qkv.b_0", ("tp",))
        _set(program, f"{pre}_multi_head_att_output_fc.w_0", ("tp", None))
        _set(program, f"{pre}_ffn_fc_0.w_0", (None, "tp"))
        _set(program, f"{pre}_ffn_fc_0.b_0", ("tp",))
        _set(program, f"{pre}_ffn_fc_1.w_0", ("tp", None))
    _set(program, "word_embedding", ("tp", None))


def random_batch(cfg, batch_size, seq_len, max_preds, rng=None):
    """A synthetic pretraining feed batch (numpy, from ``rng``)."""
    rng = rng or np.random.default_rng(0)
    flat_pos = (np.arange(batch_size)[:, None] * seq_len +
                rng.integers(0, seq_len, (batch_size, max_preds)))
    return {
        "src_ids": rng.integers(0, cfg.vocab_size,
                                (batch_size, seq_len), dtype=np.int32),
        "sent_ids": rng.integers(0, cfg.type_vocab_size,
                                 (batch_size, seq_len), dtype=np.int32),
        "pos_ids": np.broadcast_to(
            np.arange(seq_len, dtype=np.int32), (batch_size, seq_len)).copy(),
        "input_mask": np.ones((batch_size, seq_len), np.float32),
        "mask_pos": flat_pos.reshape(-1).astype(np.int32),
        "mask_label": rng.integers(
            0, cfg.vocab_size, (batch_size * max_preds, 1), dtype=np.int32),
        "labels": rng.integers(0, 2, (batch_size, 1), dtype=np.int32),
    }


def split_batch(feed, index, count, axis=0):
    """Part ``index`` of ``count`` equal parts of a :func:`random_batch`
    feed's rows (``axis``: the batch axis, 1 for a slab of steps): the
    rows of each batch-major array, and the part's block of the
    flattened masked positions and labels, its positions re-based onto
    the part's own rows (``mask_pos`` indexes the flattened ``[rows,
    seq_len]`` tokens). What a data-parallel rank of ``count`` is fed of
    a global batch."""
    rows = feed["src_ids"].shape[axis]
    seq = feed["src_ids"].shape[axis + 1]
    b = rows // count
    out = {}
    for k, v in feed.items():
        n = np.shape(v)[axis] // count
        part = np.take(v, np.arange(index * n, (index + 1) * n), axis=axis)
        if k == "mask_pos":
            part = part - np.int32(index * b * seq)
        out[k] = part
    return out


# --------------------------------------------------------------- parameters

def param_shapes(cfg):
    """``{parameter name: shape}`` of :func:`bert_pretrain`'s program."""
    h, f, V = cfg.hidden_size, cfg.ffn_size, cfg.vocab_size
    shapes = {"word_embedding": (V, h),
              "pos_embedding": (cfg.max_position, h),
              "sent_embedding": (cfg.type_vocab_size, h)}
    lns = ["pre_encoder_layer_norm", "mask_lm_trans_layer_norm"]
    fcs = {"mask_lm_trans_fc": (h, h), "pooled_fc": (h, h),
           "next_sent_fc": (h, 2)}
    for i in range(cfg.num_layers):
        pre = f"encoder_layer_{i}"
        fcs.update({f"{pre}_multi_head_att_qkv": (h, 3 * h),
                    f"{pre}_multi_head_att_output_fc": (h, h),
                    f"{pre}_ffn_fc_0": (h, f), f"{pre}_ffn_fc_1": (f, h)})
        lns += [f"{pre}_post_att_layer_norm", f"{pre}_post_ffn_layer_norm"]
    for name, (fin, fout) in fcs.items():
        shapes[f"{name}.w_0"] = (fin, fout)
        shapes[f"{name}.b_0"] = (fout,)
    for name in lns:
        shapes[f"{name}_scale"] = (h,)
        shapes[f"{name}_bias"] = (h,)
    shapes["mask_lm_out_fc.b_0"] = (V,)
    return shapes


def params_from_jax(cfg, arrays):
    """``{JAX scope name: array}`` -> ``{name: float32 CPU tensor}``,
    checked against :func:`param_shapes`: raises on a missing, extra or
    mis-shaped name."""
    want = param_shapes(cfg)
    missing = sorted(set(want) - set(arrays))
    extra = sorted(set(arrays) - set(want))
    if missing or extra:
        raise ValueError(f"BERT parameters do not match the config: "
                         f"missing {missing}, unexpected {extra}")
    out = {}
    for name, shape in want.items():
        a = arrays[name]
        t = a.detach().to(torch.float32, copy=True) \
            if isinstance(a, torch.Tensor) \
            else torch.from_numpy(np.array(a, dtype=np.float32))
        if tuple(t.shape) != shape:
            raise ValueError(f"BERT parameter {name!r} has shape "
                             f"{tuple(t.shape)}, expected {shape}")
        out[name] = t
    return out


def init_params(cfg, seed=0):
    """Seeded random parameters with the JAX startup's initializers: a
    normal truncated at two standard deviations of
    ``initializer_range`` for weights, embeddings and layer-norm scales,
    zeros for biases. Float32 CPU tensors."""
    gen = torch.Generator().manual_seed(int(seed))
    out = {}
    for name, shape in param_shapes(cfg).items():
        t = torch.zeros(shape)
        if not (name.endswith(".b_0") or name.endswith("_bias")):
            torch.nn.init.trunc_normal_(t, 0.0, 1.0, -2.0, 2.0,
                                        generator=gen)
            t *= cfg.initializer_range
        out[name] = t
    return out
