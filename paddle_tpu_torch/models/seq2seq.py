"""GRU seq2seq with beam-search decoding (a copy of
``paddle_tpu/models/seq2seq.py``): ``encoder``, ``seq2seq_train`` and
``seq2seq_beam_decode``, plus :func:`param_shapes` /
:func:`params_from_jax`, the parameters the two programs share by name.

Training runs two ``StaticRNN``s (``recurrent`` ops over their step
blocks); the decode program is a build-time loop over the static decode
length whose per-step expansion is the ``beam_search`` op (top-beam over
beam * vocab) and whose parent back-trace is ``gather_tree``: static
shapes throughout, so the decode captures as one CUDA graph."""
import numpy as np

from .. import layers
from ..layers import math as M
from ..layers import tensor as T
from ..param_attr import ParamAttr
from ..framework import initializer as I
from .params import pick_params


def _emb(ids, vocab, dim, name):
    return layers.embedding(
        ids, size=[vocab, dim],
        param_attr=ParamAttr(name=name,
                             initializer=I.Uniform(-0.1, 0.1)))


def _gru_params(prefix):
    return dict(param_attr=ParamAttr(name=f"{prefix}.w"),
                bias_attr=ParamAttr(name=f"{prefix}.b",
                                    initializer=I.Constant(0.0)))


def encoder(src_ids, vocab, emb_dim, hidden, batch):
    """src_ids [T, B] time-major -> final hidden state [B, H]."""
    T_src = src_ids.shape[0]
    # explicit [T, B, 1] id layout: the v1 lookup squeezes a trailing
    # size-1 dim, which would otherwise eat the batch dim when B == 1
    ids3 = T.reshape(src_ids, [T_src, batch, 1])
    emb = _emb(ids3, vocab, emb_dim, "seq2seq.src_emb")    # [T, B, E]
    h0 = T.fill_constant([batch, hidden], "float32", 0.0)
    rnn = layers.StaticRNN()
    with rnn.step():
        x_t = rnn.step_input(emb)
        h_prev = rnn.memory(init=h0)
        h = layers.nn.gru_unit(x_t, h_prev, **_gru_params("seq2seq.enc"))
        rnn.update_memory(h_prev, h)
        rnn.step_output(h)
    seq = rnn()                                 # [T, B, H]
    last = T.reshape(T.slice(seq, axes=[0], starts=[T_src - 1],
                             ends=[T_src]), [batch, hidden])
    return last


def _dec_logits(x_t, h_prev, vocab):
    """One decoder step: GRU + projection. Returns (h, logits)."""
    h = layers.nn.gru_unit(x_t, h_prev, **_gru_params("seq2seq.dec"))
    logits = layers.fc(h, vocab,
                       param_attr=ParamAttr(name="seq2seq.out.w"),
                       bias_attr=ParamAttr(name="seq2seq.out.b",
                                           initializer=I.Constant(0.0)))
    return h, logits


def seq2seq_train(src_vocab, tgt_vocab, emb_dim, hidden, T_src, T_tgt,
                  batch):
    """Teacher-forced training graph. Feeds: src [T_src, B] int64,
    tgt_in/tgt_out [T_tgt, B] int64. Returns dict(loss=...)."""
    src = T.data("src", [T_src, batch], dtype="int64")
    tgt_in = T.data("tgt_in", [T_tgt, batch], dtype="int64")
    tgt_out = T.data("tgt_out", [T_tgt, batch], dtype="int64")

    enc_h = encoder(src, src_vocab, emb_dim, hidden, batch)
    dec_emb = _emb(T.reshape(tgt_in, [T_tgt, batch, 1]), tgt_vocab,
                   emb_dim, "seq2seq.tgt_emb")

    rnn = layers.StaticRNN()
    with rnn.step():
        x_t = rnn.step_input(dec_emb)
        h_prev = rnn.memory(init=enc_h)
        h, logits = _dec_logits(x_t, h_prev, tgt_vocab)
        rnn.update_memory(h_prev, h)
        rnn.step_output(logits)
    logits_seq = rnn()                          # [T_tgt, B, V]
    flat_logits = T.reshape(logits_seq, [T_tgt * batch, tgt_vocab])
    flat_labels = T.reshape(tgt_out, [T_tgt * batch, 1])
    loss = layers.mean(
        layers.softmax_with_cross_entropy(flat_logits, flat_labels))
    return {"loss": loss, "src": src, "tgt_in": tgt_in, "tgt_out": tgt_out}


def seq2seq_beam_decode(src_vocab, tgt_vocab, emb_dim, hidden, T_src,
                        max_len, beam_size, bos_id=1, eos_id=2):
    """Beam-search decode graph for ONE source sentence (B=1; the demo
    decode shape of the reference book test). Feeds: src [T_src, 1].
    Returns the [max_len, 1, beam] token matrix variable (best beam =
    column 0)."""
    src = T.data("src", [T_src, 1], dtype="int64")
    enc_h = encoder(src, src_vocab, emb_dim, hidden, 1)
    # replicate the encoder state across the beam
    state = layers.concat([enc_h] * beam_size, axis=0)   # [beam, H]
    pre_ids = T.fill_constant([1, beam_size], "int64", float(bos_id))
    # only beam 0 is live at t=0 — identical replicated states would
    # otherwise tie in top_k and collapse the beam to greedy search
    pre_scores = T.assign(np.asarray(
        [[0.0] + [-1e30] * (beam_size - 1)], np.float32))

    step_ids, step_parents = [], []
    for t in range(max_len):
        ids_flat = T.reshape(pre_ids, [beam_size, 1])
        x_t = T.reshape(_emb(ids_flat, tgt_vocab, emb_dim,
                             "seq2seq.tgt_emb"), [beam_size, emb_dim])
        state, logits = _dec_logits(x_t, state, tgt_vocab)  # [beam, V]
        log_probs = layers.log_softmax(logits)
        sel_ids, sel_scores, parents = layers.nn.beam_search(
            pre_ids, pre_scores, log_probs, beam_size, end_id=eos_id)
        # reorder beam state by parent and continue with selected tokens
        state = layers.gather(state, T.reshape(parents, [beam_size]))
        pre_ids = T.cast(sel_ids, "int64")
        pre_scores = sel_scores
        step_ids.append(T.reshape(sel_ids, [1, 1, beam_size]))
        step_parents.append(T.reshape(parents, [1, 1, beam_size]))

    ids_mat = layers.concat(step_ids, axis=0)        # [T, 1, beam]
    parents_mat = layers.concat(step_parents, axis=0)
    out = layers.nn.gather_tree(ids_mat, parents_mat)
    return {"src": src, "sequences": out, "scores": pre_scores}


def param_shapes(src_vocab, tgt_vocab, emb_dim, hidden):
    """{name: shape} of the parameters, shared by name between the
    training and the decode program."""
    shapes = {"seq2seq.src_emb": (src_vocab, emb_dim),
              "seq2seq.tgt_emb": (tgt_vocab, emb_dim),
              "seq2seq.out.w": (hidden, tgt_vocab),
              "seq2seq.out.b": (tgt_vocab,)}
    for part in ("enc", "dec"):
        shapes[f"seq2seq.{part}.w.gate"] = (emb_dim + hidden, 2 * hidden)
        shapes[f"seq2seq.{part}.b.gate"] = (2 * hidden,)
        shapes[f"seq2seq.{part}.w.cand"] = (emb_dim + hidden, hidden)
        shapes[f"seq2seq.{part}.b.cand"] = (hidden,)
    return shapes


def params_from_jax(arrays, src_vocab, tgt_vocab, emb_dim, hidden):
    """``{JAX scope name: array}`` -> ``{name: float32 CPU tensor}`` for
    the names of :func:`param_shapes` (other scope state, such as Adam's
    moments, is left out); raises on a missing or mis-shaped name."""
    return pick_params(arrays, param_shapes(src_vocab, tgt_vocab, emb_dim,
                                            hidden), "seq2seq")
