"""DyGraph Transformer for machine translation (``BASELINE.md`` config
5; a copy of ``paddle_tpu/models/transformer.py``). Encoder-decoder with
multi-head attention (``matmul`` + ``softmax``) built from dygraph.nn
layers; each op runs eagerly through the registered lowerings, or inside
one CUDA graph per step under ``dygraph.jit_step``."""
import numpy as np

from .. import layers
from ..dygraph import Layer, Linear, Embedding, LayerNorm, to_variable
from ..framework import initializer as I
from ..param_attr import ParamAttr


class MultiHeadAttention(Layer):
    def __init__(self, d_model, n_head, dropout=0.1):
        super().__init__()
        self.n_head = n_head
        self.d_key = d_model // n_head
        self.q_fc = Linear(d_model, d_model, bias_attr=False)
        self.k_fc = Linear(d_model, d_model, bias_attr=False)
        self.v_fc = Linear(d_model, d_model, bias_attr=False)
        self.out_fc = Linear(d_model, d_model, bias_attr=False)
        self._dropout = dropout

    def _split(self, x):
        # [B, T, D] -> [B, H, T, D/H]
        b, t = x.shape[0], x.shape[1]
        x = layers.reshape(x, [b, t, self.n_head, self.d_key])
        return layers.transpose(x, [0, 2, 1, 3])

    def forward(self, q, kv=None, bias=None):
        kv = q if kv is None else kv
        qh = self._split(self.q_fc(q))
        kh = self._split(self.k_fc(kv))
        vh = self._split(self.v_fc(kv))
        scores = layers.matmul(qh, kh, transpose_y=True,
                               alpha=self.d_key ** -0.5)
        if bias is not None:
            scores = scores + bias
        probs = layers.softmax(scores)
        if self.training and self._dropout:
            probs = layers.dropout(probs, self._dropout,
                                   dropout_implementation="upscale_in_train")
        ctx = layers.matmul(probs, vh)                  # [B,H,T,dk]
        ctx = layers.transpose(ctx, [0, 2, 1, 3])
        b, t = ctx.shape[0], ctx.shape[1]
        ctx = layers.reshape(ctx, [b, t, self.n_head * self.d_key])
        return self.out_fc(ctx)


class FFN(Layer):
    def __init__(self, d_model, d_inner, dropout=0.1):
        super().__init__()
        self.fc1 = Linear(d_model, d_inner, act="relu")
        self.fc2 = Linear(d_inner, d_model)
        self._dropout = dropout

    def forward(self, x):
        h = self.fc1(x)
        if self.training and self._dropout:
            h = layers.dropout(h, self._dropout,
                               dropout_implementation="upscale_in_train")
        return self.fc2(h)


class EncoderLayer(Layer):
    def __init__(self, d_model, n_head, d_inner, dropout=0.1):
        super().__init__()
        self.attn = MultiHeadAttention(d_model, n_head, dropout)
        self.ffn = FFN(d_model, d_inner, dropout)
        self.ln1 = LayerNorm(d_model)
        self.ln2 = LayerNorm(d_model)

    def forward(self, x, bias):
        x = self.ln1(x + self.attn(x, bias=bias))
        return self.ln2(x + self.ffn(x))


class DecoderLayer(Layer):
    def __init__(self, d_model, n_head, d_inner, dropout=0.1):
        super().__init__()
        self.self_attn = MultiHeadAttention(d_model, n_head, dropout)
        self.cross_attn = MultiHeadAttention(d_model, n_head, dropout)
        self.ffn = FFN(d_model, d_inner, dropout)
        self.ln1 = LayerNorm(d_model)
        self.ln2 = LayerNorm(d_model)
        self.ln3 = LayerNorm(d_model)

    def forward(self, x, enc_out, self_bias, cross_bias):
        x = self.ln1(x + self.self_attn(x, bias=self_bias))
        x = self.ln2(x + self.cross_attn(x, kv=enc_out, bias=cross_bias))
        return self.ln3(x + self.ffn(x))


def _position_encoding(max_len, d_model):
    pos = np.arange(max_len)[:, None]
    dim = np.arange(0, d_model, 2)[None, :]
    angle = pos / np.power(10000.0, dim / d_model)
    enc = np.zeros((max_len, d_model), np.float32)
    enc[:, 0::2] = np.sin(angle)
    enc[:, 1::2] = np.cos(angle)
    return enc


class Transformer(Layer):
    """Transformer-base MT model (d_model 512, 6+6 layers, 8 heads)."""

    def __init__(self, src_vocab, tgt_vocab, d_model=512, n_head=8,
                 d_inner=2048, n_layer=6, max_len=256, dropout=0.1):
        super().__init__()
        self.d_model = d_model
        emb_attr = ParamAttr(initializer=I.Normal(0, d_model ** -0.5))
        self.src_emb = Embedding([src_vocab, d_model], param_attr=emb_attr)
        self.tgt_emb = Embedding([tgt_vocab, d_model], param_attr=emb_attr)
        self._pos = _position_encoding(max_len, d_model)
        self.enc_layers = [EncoderLayer(d_model, n_head, d_inner, dropout)
                           for _ in range(n_layer)]
        self.dec_layers = [DecoderLayer(d_model, n_head, d_inner, dropout)
                           for _ in range(n_layer)]
        for i, l in enumerate(self.enc_layers):
            self.add_sublayer(f"enc_{i}", l)
        for i, l in enumerate(self.dec_layers):
            self.add_sublayer(f"dec_{i}", l)
        self.out_fc = Linear(d_model, tgt_vocab, bias_attr=False)
        self._dropout = dropout

    def _embed(self, emb_layer, ids):
        x = emb_layer(ids) * (self.d_model ** 0.5)
        t = ids.shape[1]
        pos = to_variable(self._pos[None, :t])
        x = x + pos
        if self.training and self._dropout:
            x = layers.dropout(x, self._dropout,
                               dropout_implementation="upscale_in_train")
        return x

    @staticmethod
    def _pad_bias(mask):
        # mask: [B, T] 1=token 0=pad -> additive bias [B,1,1,T]
        m = layers.unsqueeze(mask, [1, 2])
        return layers.scale(m, scale=1e4, bias=-1e4)

    @staticmethod
    def _causal_bias(t):
        tri = np.triu(np.full((t, t), -1e4, np.float32), k=1)
        return to_variable(tri[None, None])

    def encode(self, src_ids, src_mask):
        x = self._embed(self.src_emb, src_ids)
        bias = self._pad_bias(src_mask)
        for layer in self.enc_layers:
            x = layer(x, bias)
        return x, bias

    def decode(self, tgt_ids, enc_out, cross_bias):
        x = self._embed(self.tgt_emb, tgt_ids)
        self_bias = self._causal_bias(tgt_ids.shape[1])
        for layer in self.dec_layers:
            x = layer(x, enc_out, self_bias, cross_bias)
        return self.out_fc(x)

    def forward(self, src_ids, src_mask, tgt_ids, labels, label_mask):
        """Teacher-forced training loss (label-position masked mean CE)."""
        enc_out, cross_bias = self.encode(src_ids, src_mask)
        logits = self.decode(tgt_ids, enc_out, cross_bias)
        v = logits.shape[-1]
        loss = layers.softmax_with_cross_entropy(
            layers.reshape(logits, [-1, v]),
            layers.reshape(labels, [-1, 1]))
        w = layers.reshape(label_mask, [-1, 1])
        loss = layers.reduce_sum(loss * w) / (layers.reduce_sum(w) + 1e-9)
        return loss


def random_batch(batch, src_len, tgt_len, src_vocab, tgt_vocab, rng=None):
    rng = rng or np.random.default_rng(0)
    return {
        "src_ids": rng.integers(1, src_vocab,
                                (batch, src_len)).astype(np.int64),
        "src_mask": np.ones((batch, src_len), np.float32),
        "tgt_ids": rng.integers(1, tgt_vocab,
                                (batch, tgt_len)).astype(np.int64),
        "labels": rng.integers(1, tgt_vocab,
                               (batch, tgt_len)).astype(np.int64),
        "label_mask": np.ones((batch, tgt_len), np.float32),
    }
