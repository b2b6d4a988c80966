"""GPT-style causal language model: pre-LN decoder blocks with a
weight-tied LM head.

Counterpart of ``paddle_tpu/models/gpt.py``, in two forms over one set
of parameter names (``word_embedding``, ``decoder_layer_{i}_qkv.w_0``,
...):

- Training: :func:`gpt_pretrain` builds the next-token-loss program
  through the Fluid layers, op for op the program the JAX package
  builds; ``fluid.Executor`` runs it. Attention is the ``flash_attention``
  op (causal), whose forward and backward are the CUDA kernels K1-K4.
- Generation: the JAX package builds a static program per mode
  (``gpt_prefill``, ``gpt_decode_step``, ``gpt_decode_step_paged``); here
  they are the methods :meth:`GPT.prefill`, :meth:`GPT.decode_step` and
  :meth:`GPT.decode_step_paged` of one ``nn.Module``. Prefill runs the
  flash-attention forward kernel (causal), the dense decode step the plain
  masked read of :func:`ops.decode_ops.kv_cached_attention`, and the
  paged decode step the paged-attention kernel over the shared block
  pool.

Layer norm has eps 1e-5, GELU is the exact erf form, ``fc`` is
``x @ W[in, out] + b`` and the head is ``h @ word_embedding.T``.
"""
import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from .. import layers
from ..device import resolve_device
from ..framework import initializer as I
from ..kernels.flash_attention import flash_attention
from ..kernels.paged_attention import paged_attention
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


def decoder_layer(cfg, x, idx, is_test):
    """Pre-LN block: x + attn(LN(x)); x + ffn(LN(x)), with causal flash
    attention over the full sequence."""
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
    ctx = layers.nn.flash_attention(q, k, v, causal=True)
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
    return M.elementwise_add(x, ffn)


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


def _attr(name):
    return name.replace(".", "__")


class GPT(nn.Module):
    """Inference GPT over ``params`` (``{JAX scope name: tensor}``) on
    ``device`` (None -> CUDA; raises without a GPU)."""

    def __init__(self, cfg, params, device=None):
        super().__init__()
        self.cfg = cfg
        self.device = resolve_device(device)
        params = params_from_jax(cfg, params)
        for name, t in params.items():
            self.register_parameter(_attr(name), nn.Parameter(
                t.to(self.device), requires_grad=False))

    def param(self, name):
        """Parameter by its JAX scope name."""
        return getattr(self, _attr(name))

    # -- pieces -----------------------------------------------------------
    def _embed(self, tokens, pos_ids):
        return F.embedding(tokens, self.param("word_embedding")) \
            + F.embedding(pos_ids, self.param("pos_embedding"))

    def _ln(self, x, name):
        return F.layer_norm(x, (self.cfg.hidden_size,),
                            self.param(f"{name}_scale"),
                            self.param(f"{name}_bias"), eps=1e-5)

    def _fc(self, x, name):
        return torch.matmul(x, self.param(f"{name}.w_0")) \
            + self.param(f"{name}.b_0")

    def _layer(self, i, x, attend):
        """Pre-LN block: x + attn(LN(x)); x + ffn(LN(x)). ``attend(q, k,
        v)`` takes and returns ``[B, H, S, D]``."""
        cfg = self.cfg
        B, S, h = x.shape
        pre = f"decoder_layer_{i}"
        qkv = self._fc(self._ln(x, f"{pre}_pre_att_ln"), f"{pre}_qkv")
        q, k, v = (t.view(B, S, cfg.num_heads, cfg.d_head).transpose(1, 2)
                   for t in qkv.split(h, dim=-1))
        ctx = attend(q, k, v).transpose(1, 2).reshape(B, S, h)
        x = x + self._fc(ctx, f"{pre}_att_out")
        f = self._ln(x, f"{pre}_pre_ffn_ln")
        f = F.gelu(self._fc(f, f"{pre}_ffn_0"), approximate="none")
        return x + self._fc(f, f"{pre}_ffn_1")

    def _next_logits(self, x, last_pos):
        """final-LN hidden [B, S, H] -> logits [B, V] at each row's
        ``last_pos`` (tied head)."""
        h = row_gather(self._ln(x, "final_ln"), last_pos)
        return torch.matmul(h, self.param("word_embedding").t())

    # -- entry points -----------------------------------------------------
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
