"""fluid.layers RNN cell / decoder API (a copy of
``paddle_tpu/layers/rnn_api.py``): ``RNNCell``, ``LSTMCell``,
``GRUCell``, ``rnn``, the decode helpers, ``BasicDecoder``,
``dynamic_decode`` and ``BeamSearchDecoder``.

``rnn()`` and ``dynamic_decode()`` unroll over the static time bound at
build time, each step's writes masked by the finished / sequence-length
state, as there; batch-major [B, T, ...] tensors, like the rest of the
masked-dense design. ``SampleEmbeddingHelper`` needs ``sampling_id``,
which is not ported: building one raises ``NotImplementedError``."""
import numpy as np

from ..framework.core import Variable
from . import math as M
from . import tensor as T
from .layer_helper import LayerHelper

__all__ = [
    "RNNCell", "LSTMCell", "GRUCell", "rnn", "Decoder", "BasicDecoder",
    "BeamSearchDecoder", "dynamic_decode", "DecodeHelper",
    "TrainingHelper", "GreedyEmbeddingHelper", "SampleEmbeddingHelper",
]


def _L():
    from .. import layers
    return layers


class RNNCell:
    """Base cell: call(inputs, states) -> (outputs, new_states)
    (reference rnn.py:38)."""

    def call(self, inputs, states, **kwargs):
        raise NotImplementedError

    def __call__(self, inputs, states, **kwargs):
        return self.call(inputs, states, **kwargs)

    def get_initial_states(self, batch_ref, shape=None, dtype="float32",
                           init_value=0.0, batch_dim_idx=0):
        B = int(batch_ref.shape[batch_dim_idx])
        shape = list(shape or [self.hidden_size])
        return T.fill_constant([B] + shape, dtype, init_value)


class LSTMCell(RNNCell):
    """reference rnn.py:159 (lstm_cell_fused lowering; gate order
    i,f,c,o with forget_bias)."""

    def __init__(self, hidden_size, param_attr=None, bias_attr=None,
                 forget_bias=1.0, dtype="float32", name="lstm_cell"):
        self.hidden_size = int(hidden_size)
        self.param_attr = param_attr
        self.bias_attr = bias_attr
        self.forget_bias = float(forget_bias)
        self.dtype = dtype
        self.name = name
        self._w = None
        self._b = None

    def call(self, inputs, states):
        h_prev, c_prev = states
        helper = LayerHelper(self.name, param_attr=self.param_attr,
                             bias_attr=self.bias_attr)
        H = self.hidden_size
        if self._w is None:
            # later calls may see inference-opaque input shapes (e.g.
            # argmax-fed embeddings); weights fix D after the first call
            D = int(inputs.shape[-1])
            self._w = helper.create_parameter(
                helper.param_attr, shape=[D + H, 4 * H], dtype=self.dtype)
            from ..framework import initializer as init_mod
            self._b = helper.create_parameter(
                helper.bias_attr, shape=[4 * H], dtype=self.dtype,
                default_initializer=init_mod.ConstantInitializer(0.0))
        h = helper.create_variable_for_type_inference(dtype=self.dtype)
        c = helper.create_variable_for_type_inference(dtype=self.dtype)
        B = (inputs.shape or h_prev.shape or (None,))[0]
        if B is not None:
            h.shape = c.shape = (B, H)
        helper.append_op(
            type="lstm_cell_fused",
            inputs={"X": [inputs], "HPrev": [h_prev], "CPrev": [c_prev],
                    "W": [self._w], "B": [self._b]},
            outputs={"H": [h], "C": [c]},
            attrs={"forget_bias": self.forget_bias},
            infer_shape=False)
        return h, [h, c]

    def get_initial_states(self, batch_ref, shape=None, dtype=None,
                           init_value=0.0, batch_dim_idx=0):
        B = int(batch_ref.shape[batch_dim_idx])
        mk = lambda: T.fill_constant([B, self.hidden_size],
                                     dtype or self.dtype, init_value)
        return [mk(), mk()]


class GRUCell(RNNCell):
    """reference rnn.py:262 (gru_cell_fused lowering)."""

    def __init__(self, hidden_size, param_attr=None, bias_attr=None,
                 dtype="float32", name="gru_cell", origin_mode=False):
        self.hidden_size = int(hidden_size)
        self.param_attr = param_attr
        self.bias_attr = bias_attr
        self.dtype = dtype
        self.name = name
        self.origin_mode = bool(origin_mode)
        self._wg = self._bg = self._wc = self._bc = None

    def call(self, inputs, states):
        h_prev = states[0] if isinstance(states, (list, tuple)) else states
        helper = LayerHelper(self.name, param_attr=self.param_attr,
                             bias_attr=self.bias_attr)
        H = self.hidden_size
        if self._wg is None:
            D = int(inputs.shape[-1])
            from ..framework import initializer as init_mod
            self._wg = helper.create_parameter(
                helper.param_attr, shape=[D + H, 2 * H], dtype=self.dtype)
            self._bg = helper.create_parameter(
                helper.bias_attr, shape=[2 * H], dtype=self.dtype,
                default_initializer=init_mod.ConstantInitializer(0.0))
            self._wc = helper.create_parameter(
                helper.param_attr, shape=[D + H, H], dtype=self.dtype)
            self._bc = helper.create_parameter(
                helper.bias_attr, shape=[H], dtype=self.dtype,
                default_initializer=init_mod.ConstantInitializer(0.0))
        h = helper.create_variable_for_type_inference(dtype=self.dtype)
        B = (inputs.shape or h_prev.shape or (None,))[0]
        if B is not None:
            h.shape = (B, H)
        helper.append_op(
            type="gru_cell_fused",
            inputs={"X": [inputs], "HPrev": [h_prev],
                    "WGate": [self._wg], "BGate": [self._bg],
                    "WCand": [self._wc], "BCand": [self._bc]},
            outputs={"H": [h]},
            attrs={"origin_mode": self.origin_mode},
            infer_shape=False)
        return h, [h]

    def get_initial_states(self, batch_ref, shape=None, dtype=None,
                           init_value=0.0, batch_dim_idx=0):
        B = int(batch_ref.shape[batch_dim_idx])
        return [T.fill_constant([B, self.hidden_size],
                                dtype or self.dtype, init_value)]


def _mask_state(new, old, mask_col):
    """new where mask else old; mask_col [B, 1] float."""
    return M.elementwise_add(
        old, M.elementwise_mul(M.elementwise_sub(new, old), mask_col))


def rnn(cell, inputs, initial_states=None, sequence_length=None,
        time_major=False, is_reverse=False, **kwargs):
    """Run a cell over a sequence (reference rnn.py:356). inputs
    [B, T, D] (or [T, B, D] with time_major); returns (outputs
    [B, T, H], final_states). Static unroll with per-step masking by
    sequence_length in place of the reference's while loop."""
    if time_major:
        nd = len(inputs.shape)
        inputs = T.transpose(inputs, [1, 0] + list(range(2, nd)))
    B, T_len = int(inputs.shape[0]), int(inputs.shape[1])
    states = initial_states
    if states is None:
        states = cell.get_initial_states(inputs)
    if isinstance(states, Variable):
        states = [states]
    mask = None
    if sequence_length is not None:
        from .sequence_lod import sequence_mask
        mask = sequence_mask(sequence_length, maxlen=T_len,
                             dtype="float32")          # [B, T]
    step_outs = []
    order = range(T_len - 1, -1, -1) if is_reverse else range(T_len)
    for t in order:
        x_t = T.reshape(
            T.slice(inputs, axes=[1], starts=[t], ends=[t + 1]),
            [B] + [int(s) for s in inputs.shape[2:]])
        out, new_states = cell(x_t, states if len(states) > 1
                               else states[0], **kwargs) \
            if not isinstance(cell, RNNCell) \
            else cell.call(x_t, states, **kwargs)
        if not isinstance(new_states, (list, tuple)):
            new_states = [new_states]
        if mask is not None:
            m_t = T.reshape(
                T.slice(mask, axes=[1], starts=[t], ends=[t + 1]),
                [B, 1])
            new_states = [_mask_state(ns, s, m_t)
                          for ns, s in zip(new_states, states)]
            out = M.elementwise_mul(out, m_t)
        states = list(new_states)
        step_outs.append(out)
    if is_reverse:
        step_outs = step_outs[::-1]
    outputs = T.stack(step_outs, axis=1)               # [B, T, H]
    if time_major:
        nd = len(outputs.shape)
        outputs = T.transpose(outputs, [1, 0] + list(range(2, nd)))
    final = states if len(states) > 1 else states[0]
    return outputs, final


# ---------------------------------------------------------------- decoding

class DecodeHelper:
    """initialize() -> (initial_inputs, initial_finished);
    sample(time, outputs, states) -> sample_ids;
    next_inputs(time, outputs, states, sample_ids)
    -> (finished, next_inputs, next_states) (reference rnn.py:1330)."""

    def initialize(self):
        raise NotImplementedError

    def sample(self, time, outputs, states):
        raise NotImplementedError

    def next_inputs(self, time, outputs, states, sample_ids):
        raise NotImplementedError


class TrainingHelper(DecodeHelper):
    """Teacher forcing from ground-truth inputs [B, T, D]
    (reference rnn.py:1378)."""

    def __init__(self, inputs, sequence_length=None, time_major=False):
        if time_major:
            nd = len(inputs.shape)
            inputs = T.transpose(inputs, [1, 0] + list(range(2, nd)))
        self.inputs = inputs
        self.sequence_length = sequence_length
        self.B = int(inputs.shape[0])
        self.T = int(inputs.shape[1])

    def _step_input(self, t):
        return T.reshape(
            T.slice(self.inputs, axes=[1], starts=[t], ends=[t + 1]),
            [self.B] + [int(s) for s in self.inputs.shape[2:]])

    def initialize(self):
        finished = T.fill_constant([self.B], "bool", False)
        if self.sequence_length is not None:
            finished = M.less_than(
                self.sequence_length,
                T.fill_constant(list(self.sequence_length.shape),
                                self.sequence_length.dtype, 1))
        return self._step_input(0), finished

    def sample(self, time, outputs, states):
        return T.argmax(outputs, axis=-1)

    def next_inputs(self, time, outputs, states, sample_ids):
        t_next = time + 1
        if t_next >= self.T:
            nxt = self._step_input(self.T - 1)   # past end: repeat last
            finished = T.fill_constant([self.B], "bool", True)
        else:
            nxt = self._step_input(t_next)
            if self.sequence_length is not None:
                finished = M.less_equal(
                    self.sequence_length,
                    T.fill_constant(list(self.sequence_length.shape),
                                    self.sequence_length.dtype,
                                    t_next))
            else:
                finished = T.fill_constant([self.B], "bool", False)
        return finished, nxt, states


class GreedyEmbeddingHelper(DecodeHelper):
    """Argmax feedback through an embedding fn (reference rnn.py:1480)."""

    def __init__(self, embedding_fn, start_tokens, end_token):
        self.embedding_fn = embedding_fn
        self.start_tokens = start_tokens          # [B] int64
        self.end_token = int(end_token)

    def initialize(self):
        B = int(self.start_tokens.shape[0])
        finished = T.fill_constant([B], "bool", False)
        return self.embedding_fn(self.start_tokens), finished

    def sample(self, time, outputs, states):
        return T.argmax(outputs, axis=-1)

    def next_inputs(self, time, outputs, states, sample_ids):
        finished = M.equal(
            T.cast(sample_ids, "int64"),
            T.fill_constant([1], "int64", self.end_token))
        return finished, self.embedding_fn(sample_ids), states


class SampleEmbeddingHelper(GreedyEmbeddingHelper):
    """Categorical sampling feedback (reference rnn.py:1550): it needs
    the ``sampling_id`` op, which is not ported."""

    def __init__(self, *args, **kwargs):
        raise NotImplementedError("paddle_tpu_torch: SampleEmbeddingHelper "
                                  "needs the sampling_id op, which is not "
                                  "ported")


class Decoder:
    """initialize(inits) -> (inputs, states, finished);
    step(time, inputs, states) -> (outputs, states, inputs, finished)
    (reference rnn.py:565)."""

    def initialize(self, inits):
        raise NotImplementedError

    def step(self, time, inputs, states, **kwargs):
        raise NotImplementedError

    def finalize(self, outputs, final_states, sequence_lengths):
        return outputs, final_states


class BasicDecoder(Decoder):
    """cell + helper (+ output layer fn) (reference rnn.py:1680).
    step outputs are (cell_outputs, sample_ids) pairs."""

    def __init__(self, cell, helper, output_fn=None):
        self.cell = cell
        self.helper = helper
        self.output_fn = output_fn

    def initialize(self, initial_cell_states):
        inputs, finished = self.helper.initialize()
        return inputs, initial_cell_states, finished

    def step(self, time, inputs, states, **kwargs):
        cell_outputs, cell_states = self.cell.call(inputs, states)
        if self.output_fn is not None:
            cell_outputs = self.output_fn(cell_outputs)
        sample_ids = self.helper.sample(time, cell_outputs, cell_states)
        finished, next_inputs, next_states = self.helper.next_inputs(
            time, cell_outputs, cell_states, sample_ids)
        return ((cell_outputs, sample_ids), next_states, next_inputs,
                finished)


def dynamic_decode(decoder, inits=None, max_step_num=None,
                   output_time_major=False, impute_finished=False,
                   is_test=False, return_length=False, **kwargs):
    """Run a Decoder to completion (reference rnn.py:1110). The loop is
    a bounded static unroll over max_step_num with finished-masked state
    updates — identical results to the reference's dynamic while loop
    for any decode that fits the bound."""
    assert max_step_num is not None, \
        "dynamic_decode needs max_step_num (a static bound)"
    inputs, states, finished = decoder.initialize(inits)
    if isinstance(states, Variable):
        states = [states]
    outputs_ta = []
    ids_ta = []
    lengths = None
    for t in range(int(max_step_num)):
        step_out, next_states, next_inputs, next_finished = decoder.step(
            t, inputs, states if len(states) > 1 else states[0], **kwargs)
        if not isinstance(next_states, (list, tuple)):
            next_states = [next_states]
        cell_out, sample_ids = step_out if isinstance(step_out, tuple) \
            else (step_out, None)
        not_fin = T.cast(_L().logical_not(finished), "float32")
        m_col = T.reshape(not_fin, [-1, 1])
        tracks_own = getattr(decoder, "tracks_own_finished_state", False)
        if not tracks_own:
            cell_out = M.elementwise_mul(cell_out, m_col)
        outputs_ta.append(cell_out)
        if sample_ids is not None:
            ids_ta.append(sample_ids)
        if lengths is None:
            lengths = T.cast(not_fin, "int64")
        else:
            lengths = M.elementwise_add(lengths, T.cast(not_fin, "int64"))
        if tracks_own:
            # the decoder's step already carried finished rows (e.g.
            # beam parent-gather); masking here would blend PRE-reorder
            # slots into the post-reorder layout
            states = list(next_states)
        else:
            states = [_mask_state(ns, s, m_col)
                      for ns, s in zip(next_states, states)]
        inputs = next_inputs
        finished = _L().logical_or(finished, next_finished)
    outputs = T.stack(outputs_ta, axis=1)          # [B, T, ...]
    ids = T.stack(ids_ta, axis=1) if ids_ta else None
    final = states if len(states) > 1 else states[0]
    outputs, final = decoder.finalize((outputs, ids), final, lengths)
    if output_time_major:
        o0 = outputs[0] if isinstance(outputs, tuple) else outputs
        nd = len(o0.shape)
        perm = [1, 0] + list(range(2, nd))
        if isinstance(outputs, tuple):
            outputs = tuple(T.transpose(o, perm[:len(o.shape)])
                            if o is not None else None for o in outputs)
        else:
            outputs = T.transpose(outputs, perm)
    if return_length:
        return outputs, final, lengths
    return outputs, final


class BeamSearchDecoder(Decoder):
    """Beam search over a cell (reference rnn.py:636): states tile to
    [B*beam, ...]; each step scores V continuations per beam with the
    beam_search op and re-gathers states by parent; finalize back-traces
    with gather_tree. tracks_own_state: the parent-gather already
    carries finished beams, and dynamic_decode's generic finished-mask
    would blend PRE-reorder slots into the post-reorder layout
    (reference BeamSearchDecoder.tracks_own_finished_state)."""

    tracks_own_finished_state = True

    def __init__(self, cell, start_token, end_token, beam_size,
                 embedding_fn=None, output_fn=None):
        self.cell = cell
        self.start_token = int(start_token)
        self.end_token = int(end_token)
        self.beam_size = int(beam_size)
        self.embedding_fn = embedding_fn
        self.output_fn = output_fn

    def _tile(self, x):
        """[B, ...] -> [B*beam, ...] (repeat each row beam times)."""
        B = int(x.shape[0])
        nd = len(x.shape)
        e = _L().unsqueeze(x, [1])                         # [B, 1, ...]
        reps = [1, self.beam_size] + [1] * (nd - 1)
        e = T.expand(e, reps)
        return T.reshape(e, [B * self.beam_size] +
                         [int(s) for s in x.shape[1:]])

    def initialize(self, initial_cell_states):
        states = initial_cell_states
        if isinstance(states, Variable):
            states = [states]
        B = int(states[0].shape[0])
        self.B = B
        states = [self._tile(s) for s in states]
        ids0 = T.fill_constant([B, self.beam_size], "int64",
                               self.start_token)
        # only beam 0 live at start: others -inf so the first expansion
        # draws from a single beam
        np_init = np.full((1, self.beam_size), -1e30, np.float32)
        np_init[0, 0] = 0.0
        scores0 = _L().expand(T.assign(np_init), [B, 1])
        self._pre_ids = ids0
        self._pre_scores = scores0
        self._ids_ta = []
        self._parents_ta = []
        inputs = self.embedding_fn(T.reshape(ids0, [-1]))
        finished = T.fill_constant([B * self.beam_size], "bool", False)
        return inputs, states, finished

    def step(self, time, inputs, states, **kwargs):
        return _beam_step(self, time, inputs, states, **kwargs)

    def finalize(self, outputs, final_states, sequence_lengths):
        return _beam_finalize(self, outputs, final_states,
                              sequence_lengths)


def _beam_step(self, time, inputs, states, **kwargs):
    from .nn import softmax
    cell_outputs, cell_states = self.cell.call(inputs, states)
    if self.output_fn is not None:
        cell_outputs = self.output_fn(cell_outputs)
    if not isinstance(cell_states, (list, tuple)):
        cell_states = [cell_states]
    probs = softmax(cell_outputs)                   # [B*beam, V]
    logp = _L().log(probs)
    sel_ids, sel_scores, parent = _L().beam_search(
        self._pre_ids, self._pre_scores, logp, self.beam_size,
        end_id=self.end_token)
    self._ids_ta.append(sel_ids)
    self._parents_ta.append(parent)
    self._pre_ids = sel_ids
    self._pre_scores = sel_scores
    # re-gather states by parent beam: flat index = b*beam + parent
    offs = T.assign(
        (np.arange(self.B, dtype=np.int64) * self.beam_size
         ).reshape(self.B, 1))
    flat_parent = T.reshape(
        M.elementwise_add(T.cast(parent, "int64"),
                          _L().expand(offs, [1, self.beam_size])), [-1])
    next_states = [T.gather(s, flat_parent) for s in cell_states]
    next_inputs = self.embedding_fn(T.reshape(sel_ids, [-1]))
    finished = T.reshape(
        M.equal(T.cast(sel_ids, "int64"),
                T.fill_constant([1], "int64", self.end_token)), [-1])
    return ((cell_outputs, sel_ids), next_states, next_inputs, finished)


def _beam_finalize(self, outputs, final_states, sequence_lengths):
    ids = T.stack(self._ids_ta, axis=0)         # [T, B, beam]
    parents = T.stack(self._parents_ta, axis=0)
    seqs = _L().gather_tree(ids, parents)
    return (seqs, self._pre_scores), final_states
