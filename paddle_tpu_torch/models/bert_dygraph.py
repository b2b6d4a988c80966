"""DyGraph BERT-base (a copy of ``paddle_tpu/models/bert_dygraph.py``):
the pretraining math of the static ``models/bert.py`` graph (post-LN
encoder, fused-QKV einsum attention, MLM head weight-tied to the word
embedding, NSP head) built from dygraph.nn Layers, so one model can be
measured through both execution paths: ``Executor.run_steps`` over the
static program against ``dygraph.jit_step``'s captured step.
"""
from .. import layers
from ..dygraph import Embedding, Layer, LayerNorm, Linear

from .bert import BertConfig, random_batch  # noqa: F401  (shared config)


class BertEncoderLayer(Layer):
    """Post-LN block matching bert.encoder_layer: fused QKV, einsum-free
    dygraph attention, residual + LN, gelu FFN, residual + LN."""

    def __init__(self, cfg):
        super().__init__()
        h = cfg.hidden_size
        self.n_head = cfg.num_heads
        self.d_head = h // cfg.num_heads
        self.qkv = Linear(h, 3 * h)
        self.out_fc = Linear(h, h)
        self.ln_att = LayerNorm(h)
        self.ffn1 = Linear(h, cfg.ffn_size, act="gelu")
        self.ffn2 = Linear(cfg.ffn_size, h)
        self.ln_ffn = LayerNorm(h)
        self._attn_drop = cfg.attn_dropout
        self._hidden_drop = cfg.hidden_dropout

    def _drop(self, x, p):
        if self.training and p:
            return layers.dropout(
                x, p, dropout_implementation="upscale_in_train")
        return x

    def forward(self, x, attn_bias):
        b, s = x.shape[0], x.shape[1]
        h = self.n_head * self.d_head
        qkv = self.qkv(x)                                   # [B,S,3H]
        # identical formulation to the static encoder_layer: slice the
        # fused projection and keep [B,S,nH,dH] through einsum — the
        # head transpose folds into the dot's dimension numbers instead
        # of materializing three transposed copies per layer
        q = layers.reshape(
            layers.slice(qkv, axes=[2], starts=[0], ends=[h]),
            [b, s, self.n_head, self.d_head])
        k = layers.reshape(
            layers.slice(qkv, axes=[2], starts=[h], ends=[2 * h]),
            [b, s, self.n_head, self.d_head])
        v = layers.reshape(
            layers.slice(qkv, axes=[2], starts=[2 * h], ends=[3 * h]),
            [b, s, self.n_head, self.d_head])
        scores = layers.scale(layers.einsum("bsnd,btnd->bnst", q, k),
                              scale=self.d_head ** -0.5)
        scores = scores + attn_bias
        probs = self._drop(layers.softmax(scores), self._attn_drop)
        ctx = layers.einsum("bnst,btnd->bsnd", probs, v)    # [B,S,nH,dH]
        ctx = layers.reshape(ctx, [b, s, h])
        attn_out = self._drop(self.out_fc(ctx), self._hidden_drop)
        x = self.ln_att(x + attn_out)
        ffn = self._drop(self.ffn2(self.ffn1(x)), self._hidden_drop)
        return self.ln_ffn(x + ffn)


class BertPretrainDy(Layer):
    """Embeddings + encoder stack + MLM/NSP heads; forward returns the
    same (mlm + nsp) loss as bert.bert_pretrain given a
    bert.random_batch feed dict's tensors."""

    def __init__(self, cfg):
        super().__init__()
        self.cfg = cfg
        h = cfg.hidden_size
        self.word_emb = Embedding([cfg.vocab_size, h])
        self.pos_emb = Embedding([cfg.max_position, h])
        self.sent_emb = Embedding([cfg.type_vocab_size, h])
        self.ln_emb = LayerNorm(h)
        self.blocks = [BertEncoderLayer(cfg) for _ in range(cfg.num_layers)]
        for i, blk in enumerate(self.blocks):
            self.add_sublayer(f"layer_{i}", blk)
        self.mlm_trans = Linear(h, h, act="gelu")
        self.ln_mlm = LayerNorm(h)
        self.mlm_bias = self.create_parameter(
            shape=[cfg.vocab_size], dtype="float32", is_bias=True)
        self.pooled_fc = Linear(h, h, act="tanh")
        self.nsp_fc = Linear(h, 2)
        self._hidden_drop = cfg.hidden_dropout

    def forward(self, src_ids, sent_ids, pos_ids, input_mask, mask_pos,
                mask_label, labels):
        cfg = self.cfg
        emb = (self.word_emb(src_ids) + self.pos_emb(pos_ids)
               + self.sent_emb(sent_ids))
        emb = self.ln_emb(emb)
        if self.training and self._hidden_drop:
            emb = layers.dropout(
                emb, self._hidden_drop,
                dropout_implementation="upscale_in_train")
        # additive bias [B,1,1,S]: 0 attend, -1e4 masked
        bias = layers.scale(layers.unsqueeze(input_mask, [1, 2]),
                            scale=10000.0, bias=-10000.0)
        x = emb
        for blk in self.blocks:
            x = blk(x, bias)

        # MLM head, weight-tied to word_emb
        flat = layers.reshape(x, [-1, cfg.hidden_size])
        picked = layers.gather(flat, mask_pos)
        trans = self.ln_mlm(self.mlm_trans(picked))
        logits = layers.matmul(trans, self.word_emb.weight,
                               transpose_y=True) + self.mlm_bias
        mlm_loss = layers.mean(
            layers.softmax_with_cross_entropy(logits, mask_label))

        # NSP head over [CLS]
        cls = layers.reshape(
            layers.slice(x, axes=[1], starts=[0], ends=[1]),
            [-1, cfg.hidden_size])
        nsp_logits = self.nsp_fc(self.pooled_fc(cls))
        nsp_loss = layers.mean(
            layers.softmax_with_cross_entropy(nsp_logits, labels))
        return mlm_loss + nsp_loss
