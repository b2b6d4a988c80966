"""The port's RNN ops, RNN cell/decoder API and the book's sequence
models against the JAX package, on the CPU:

- the cases of ``tests/test_ops_rnn.py`` for the ops of this slice
  (``lstm`` plain, with peepholes and reversed, ``lstmp``,
  ``lstm_unit``, ``gru``, ``gru_unit`` in both modes, ``row_conv``,
  ``conv_shift``, ``im2sequence``, ``grid_sampler``, the bicubic and
  trilinear resizes (also at sizes that grow and shrink),
  ``sequence_expand``, ``sequence_scatter``, ``lod_reset`` and
  ``shrink_rnn_memory``), each op
  alone in a program of both packages on the same seeded inputs
  (``tests/torch_pair.py``): outputs within 1e-5 of max |ref|, input
  grads within 1e-4, and the JAX test's numpy reference; also the fused
  cells ``lstm_cell_fused`` / ``gru_cell_fused`` the layers emit;
- the three cases of ``tests/test_rnn_api.py`` (``rnn`` over an
  ``LSTMCell`` with lengths, ``BasicDecoder`` greedy, and
  ``BeamSearchDecoder``): the port's fetches equal JAX's on the JAX
  startup's weights (ids exactly);
- ``tests/test_book.py``'s sentiment LSTM (``lstm`` + ``sequence_pool``
  "last") and its ``dynamic_gru`` encoder-decoder: 3 Adam steps in both
  packages, losses within 1e-5 of max |ref| and every parameter and
  Adam slot within rtol 1e-5, atol 1e-5; then the port alone to the JAX
  test's step count and loss drop.
"""
import numpy as np
import pytest

import paddle_tpu_torch as tfluid

from torch_pair import assert_pair, assert_scopes_close, op_pair, run_pair

RNG = np.random.default_rng(7)


def _sig(x):
    return 1.0 / (1.0 + np.exp(-x))


def _check(got, ref, tol=1e-4):
    np.testing.assert_allclose(got, ref, rtol=tol, atol=tol)


def _np_lstm(x, w, b, lengths, peep=False):
    B, T, H4 = x.shape
    H = H4 // 4
    h = np.zeros((B, H))
    c = np.zeros((B, H))
    hid = np.zeros((B, T, H))
    cell = np.zeros((B, T, H))
    for t in range(T):
        gi, gf, gc, go = np.split(x[:, t] + h @ w + b[:, :4 * H], 4, -1)
        if peep:
            gi = gi + c * b[:, 4 * H:5 * H]
            gf = gf + c * b[:, 5 * H:6 * H]
        cn = _sig(gf) * c + _sig(gi) * np.tanh(gc)
        go2 = go + cn * b[:, 6 * H:7 * H] if peep else go
        hn = _sig(go2) * np.tanh(cn)
        live = (t < lengths)[:, None]
        h = np.where(live, hn, h)
        c = np.where(live, cn, c)
        hid[:, t] = np.where(live, h, 0)
        cell[:, t] = np.where(live, c, 0)
    return hid, cell


def _lstm_inputs(B, T, H, bias_w, lens):
    x = RNG.standard_normal((B, T, 4 * H)).astype(np.float32)
    w = (RNG.standard_normal((H, 4 * H)) * 0.5).astype(np.float32)
    b = (RNG.standard_normal((1, bias_w)) * 0.1).astype(np.float32)
    return {"Input": x, "Weight": w, "Bias": b,
            "Length": np.array(lens, np.int32)}


def test_lstm():
    B, T, H = 3, 5, 4
    ins = _lstm_inputs(B, T, H, 4 * H, [5, 3, 4])
    out = {"Hidden": ((B, T, H), "float32"), "Cell": ((B, T, H), "float32")}
    to, _ = op_pair("lstm", ins, {}, out, grad_slots=("Input", "Weight"))
    hid, cell = _np_lstm(ins["Input"], ins["Weight"], ins["Bias"],
                         ins["Length"])
    _check(to["Hidden"], hid)
    _check(to["Cell"], cell)


def test_lstm_peepholes():
    B, T, H = 2, 4, 3
    ins = _lstm_inputs(B, T, H, 7 * H, [4, 2])
    to, _ = op_pair("lstm", ins, {"use_peepholes": True},
                    {"Hidden": ((B, T, H), "float32"),
                     "Cell": ((B, T, H), "float32")},
                    grad_slots=("Input", "Bias"))
    hid, cell = _np_lstm(ins["Input"], ins["Weight"], ins["Bias"],
                         ins["Length"], peep=True)
    _check(to["Hidden"], hid)
    _check(to["Cell"], cell)


def test_lstm_reverse_matches_flipped_forward():
    B, T, H = 2, 4, 3
    ins = _lstm_inputs(B, T, H, 4 * H, [4, 3])
    ins["Bias"] = np.zeros_like(ins["Bias"])
    to, _ = op_pair("lstm", ins, {"is_reverse": True},
                    {"Hidden": ((B, T, H), "float32"),
                     "Cell": ((B, T, H), "float32")}, grad_slots=("Input",))
    x, lens = ins["Input"], ins["Length"]
    xr = x.copy()
    for i, ln in enumerate(lens):
        xr[i, :ln] = x[i, :ln][::-1]
    hid, cell = _np_lstm(xr, ins["Weight"], ins["Bias"], lens)
    for i, ln in enumerate(lens):
        hid[i, :ln] = hid[i, :ln][::-1]
        cell[i, :ln] = cell[i, :ln][::-1]
    _check(to["Hidden"], hid)
    _check(to["Cell"], cell)


def test_lstmp():
    B, T, H, P = 2, 4, 3, 2
    x = RNG.standard_normal((B, T, 4 * H)).astype(np.float32)
    w = (RNG.standard_normal((P, 4 * H)) * 0.5).astype(np.float32)
    wp = (RNG.standard_normal((H, P)) * 0.5).astype(np.float32)
    b = (RNG.standard_normal((1, 4 * H)) * 0.1).astype(np.float32)
    lens = np.array([4, 3], np.int32)
    to, _ = op_pair("lstmp", {"Input": x, "Weight": w, "ProjWeight": wp,
                              "Bias": b, "Length": lens}, {},
                    {"Projection": ((B, T, P), "float32"),
                     "Cell": ((B, T, H), "float32")},
                    grad_slots=("Input", "ProjWeight"))
    r, c = np.zeros((B, P)), np.zeros((B, H))
    proj = np.zeros((B, T, P))
    for t in range(T):
        gi, gf, gc, go = np.split(x[:, t] + r @ w + b, 4, -1)
        cn = _sig(gf) * c + _sig(gi) * np.tanh(gc)
        rn = (_sig(go) * np.tanh(cn)) @ wp
        live = (t < lens)[:, None]
        r, c = np.where(live, rn, r), np.where(live, cn, c)
        proj[:, t] = np.where(live, r, 0)
    _check(to["Projection"], proj)


def test_lstm_unit():
    B, H = 3, 4
    x = RNG.standard_normal((B, 4 * H)).astype(np.float32)
    c_prev = RNG.standard_normal((B, H)).astype(np.float32)
    to, _ = op_pair("lstm_unit", {"X": x, "C_prev": c_prev},
                    {"forget_bias": 0.5},
                    {"H": ((B, H), "float32"), "C": ((B, H), "float32")},
                    grad_slots=("X", "C_prev"))
    i, f, ch, o = np.split(x, 4, axis=-1)
    c = _sig(f + 0.5) * c_prev + _sig(i) * np.tanh(ch)
    _check(to["C"], c, 1e-5)
    _check(to["H"], _sig(o) * np.tanh(c), 1e-5)


def _np_gru_step(xt, h, w, b, H, origin=False):
    u, r = np.split(_sig(xt[:, :2 * H] + h @ w[:, :2 * H] + b[:, :2 * H]),
                    2, axis=-1)
    cand = np.tanh(xt[:, 2 * H:] + (r * h) @ w[:, 2 * H:] + b[:, 2 * H:])
    return u * h + (1 - u) * cand if origin else u * cand + (1 - u) * h


def test_gru():
    B, T, H = 3, 5, 4
    x = RNG.standard_normal((B, T, 3 * H)).astype(np.float32)
    w = (RNG.standard_normal((H, 3 * H)) * 0.5).astype(np.float32)
    b = (RNG.standard_normal((1, 3 * H)) * 0.1).astype(np.float32)
    lens = np.array([5, 2, 4], np.int32)
    to, _ = op_pair("gru", {"Input": x, "Weight": w, "Bias": b,
                            "Length": lens}, {},
                    {"Hidden": ((B, T, H), "float32")},
                    grad_slots=("Input", "Weight"))
    h = np.zeros((B, H))
    hid = np.zeros((B, T, H))
    for t in range(T):
        live = (t < lens)[:, None]
        h = np.where(live, _np_gru_step(x[:, t], h, w, b, H), h)
        hid[:, t] = np.where(live, h, 0)
    _check(to["Hidden"], hid)


@pytest.mark.parametrize("origin", [False, True])
def test_gru_unit_both_modes(origin):
    B, H = 3, 4
    x = RNG.standard_normal((B, 3 * H)).astype(np.float32)
    h = RNG.standard_normal((B, H)).astype(np.float32)
    w = (RNG.standard_normal((H, 3 * H)) * 0.5).astype(np.float32)
    b = (RNG.standard_normal((1, 3 * H)) * 0.1).astype(np.float32)
    to, _ = op_pair("gru_unit", {"Input": x, "HiddenPrev": h, "Weight": w,
                                 "Bias": b}, {"origin_mode": origin},
                    {"Hidden": ((B, H), "float32")},
                    grad_slots=("Input", "HiddenPrev"))
    _check(to["Hidden"], _np_gru_step(x, h, w, b, H, origin), 1e-5)


def test_fused_cells():
    """The cells the layers emit (``lstm_unit`` / ``gru_unit`` /
    ``LSTMCell`` / ``GRUCell``), gates packed (i, f, c_hat, o) and (u, r)
    + candidate as the JAX package packs them."""
    B, D, H = 3, 5, 4
    x = RNG.standard_normal((B, D)).astype(np.float32)
    h = RNG.standard_normal((B, H)).astype(np.float32)
    c = RNG.standard_normal((B, H)).astype(np.float32)
    w = (RNG.standard_normal((D + H, 4 * H)) * 0.5).astype(np.float32)
    b = (RNG.standard_normal((4 * H,)) * 0.1).astype(np.float32)
    to, _ = op_pair("lstm_cell_fused", {"X": x, "HPrev": h, "CPrev": c,
                                        "W": w, "B": b},
                    {"forget_bias": 1.0},
                    {"H": ((B, H), "float32"), "C": ((B, H), "float32")},
                    grad_slots=("X", "HPrev", "W"))
    i, f, ch, o = np.split(np.concatenate([x, h], 1) @ w + b, 4, -1)
    _check(to["C"], _sig(f + 1.0) * c + _sig(i) * np.tanh(ch), 1e-5)
    for origin in (False, True):
        op_pair("gru_cell_fused",
                {"X": x, "HPrev": h, "WGate": w[:, :2 * H],
                 "BGate": b[:2 * H], "WCand": w[:, 2 * H:3 * H],
                 "BCand": b[2 * H:3 * H]}, {"origin_mode": origin},
                {"H": ((B, H), "float32")},
                grad_slots=("X", "HPrev", "WGate", "WCand"))


def test_row_conv():
    B, T, D, K = 2, 6, 3, 3
    x = RNG.standard_normal((B, T, D)).astype(np.float32)
    filt = RNG.standard_normal((K, D)).astype(np.float32)
    lens = np.array([6, 4], np.int32)
    ref = np.zeros_like(x)
    for b in range(B):
        for t in range(lens[b]):
            for k in range(K):
                if t + k < lens[b]:
                    ref[b, t] += x[b, t + k] * filt[k]
    to, _ = op_pair("row_conv", {"X": x, "Filter": filt, "Length": lens},
                    {}, {"Out": ((B, T, D), "float32")},
                    grad_slots=("X", "Filter"))
    _check(to["Out"], ref, 1e-5)


def test_conv_shift():
    B, N, M = 2, 7, 3
    x = RNG.standard_normal((B, N)).astype(np.float32)
    y = RNG.standard_normal((B, M)).astype(np.float32)
    ref = np.zeros((B, N), np.float32)
    for b in range(B):
        for i in range(N):
            for j in range(M):
                ref[b, i] += x[b, (i + j - M // 2) % N] * y[b, j]
    to, _ = op_pair("conv_shift", {"X": x, "Y": y}, {},
                    {"Out": ((B, N), "float32")}, grad_slots=("X", "Y"))
    _check(to["Out"], ref, 1e-5)


def test_im2sequence():
    B, C, H, W = 2, 3, 5, 4
    kh, kw, sh, sw = 2, 2, 1, 2
    x = RNG.standard_normal((B, C, H, W)).astype(np.float32)
    oh, ow = (H - kh) // sh + 1, (W - kw) // sw + 1
    ref = np.zeros((B, oh * ow, C * kh * kw), np.float32)
    for b in range(B):
        for i in range(oh):
            for j in range(ow):
                ref[b, i * ow + j] = x[b, :, i * sh:i * sh + kh,
                                       j * sw:j * sw + kw].reshape(-1)
    to, _ = op_pair("im2sequence", {"X": x},
                    {"kernels": [kh, kw], "strides": [sh, sw]},
                    {"Out": ((B, oh * ow, C * kh * kw), "float32"),
                     "OutLength": ((B,), "int32")}, grad_slots=("X",))
    _check(to["Out"], ref, 1e-5)
    np.testing.assert_array_equal(to["OutLength"], np.full(B, oh * ow))


def test_grid_sampler_identity_grid():
    B, C, H, W = 2, 3, 4, 5
    x = RNG.standard_normal((B, C, H, W)).astype(np.float32)
    ys, xs = np.meshgrid(np.linspace(-1, 1, H), np.linspace(-1, 1, W),
                         indexing="ij")
    grid = np.stack([xs, ys], axis=-1)[None].repeat(B, 0).astype(np.float32)
    to, _ = op_pair("grid_sampler", {"X": x, "Grid": grid}, {},
                    {"Out": ((B, C, H, W), "float32")}, grad_slots=("X",))
    _check(to["Out"], x, 1e-5)


def test_grid_sampler_shift_half_pixel():
    x = np.arange(4, dtype=np.float32).reshape(1, 1, 1, 4)
    gx = (np.array([0.5, 1.5, 2.5]) / 3) * 2 - 1
    grid = np.stack([gx, np.zeros(3)], -1).reshape(1, 1, 3, 2)
    to, _ = op_pair("grid_sampler", {"X": x, "Grid": grid.astype(
        np.float32)}, {}, {"Out": ((1, 1, 1, 3), "float32")})
    _check(to["Out"], [[[[0.5, 1.5, 2.5]]]], 1e-6)


@pytest.mark.parametrize("size", [(4, 3), (7, 5), (3, 2)],
                         ids=["same", "grow", "shrink"])
def test_bicubic_and_trilinear_interp(size):
    """At the input's size both are the identity (the JAX test's case);
    growing and shrinking (antialiased) they follow ``jax.image.resize``."""
    hw, d = size
    x = RNG.standard_normal((2, 3, 4, 4)).astype(np.float32)
    to, _ = op_pair("bicubic_interp", {"X": x}, {"out_h": hw, "out_w": hw},
                    {"Out": ((2, 3, hw, hw), "float32")}, grad_slots=("X",))
    v = RNG.standard_normal((2, 2, 3, 3, 3)).astype(np.float32)
    tv, _ = op_pair("trilinear_interp", {"X": v},
                    {"out_d": d, "out_h": d, "out_w": 3},
                    {"Out": ((2, 2, d, d, 3), "float32")}, grad_slots=("X",))
    if hw == 4:
        _check(to["Out"], x, 1e-5)
        _check(tv["Out"], v, 1e-5)


def test_sequence_expand():
    B, T, D = 3, 4, 2
    x = RNG.standard_normal((B, T, D)).astype(np.float32)
    lens = np.array([4, 2, 3], np.int32)
    rep = np.array([2, 0, 3], np.int32)
    ref = np.zeros((6, T, D), np.float32)
    ref_len = np.zeros(6, np.int32)
    j = 0
    for i in range(B):
        for _ in range(rep[i]):
            ref[j], ref_len[j] = x[i], lens[i]
            j += 1
    to, _ = op_pair("sequence_expand",
                    {"X": x, "Length": lens, "RepeatTimes": rep},
                    {"out_rows": 6},
                    {"Out": ((6, T, D), "float32"),
                     "OutLength": ((6,), "int32")}, grad_slots=("X",))
    _check(to["Out"], ref, 1e-6)
    np.testing.assert_array_equal(to["OutLength"], ref_len)


def test_sequence_scatter():
    B, D = 2, 5
    x = RNG.standard_normal((B, D)).astype(np.float32)
    ids = np.array([[0, 2, 2], [4, 1, 0]], np.int32)
    upd = RNG.standard_normal((B, 3)).astype(np.float32)
    ln = np.array([3, 2], np.int32)
    ref = x.copy()
    for b in range(B):
        for u in range(ln[b]):
            ref[b, ids[b, u]] += upd[b, u]
    to, _ = op_pair("sequence_scatter",
                    {"X": x, "Ids": ids, "Updates": upd, "UpdLength": ln},
                    {}, {"Out": ((B, D), "float32")},
                    grad_slots=("X", "Updates"))
    _check(to["Out"], ref, 1e-6)


def test_lod_reset_and_shrink_rnn_memory():
    B, T, D = 2, 4, 3
    x = RNG.standard_normal((B, T, D)).astype(np.float32)
    new_len = np.array([2, 4], np.int32)
    to, _ = op_pair("lod_reset", {"X": x, "Y": new_len}, {},
                    {"Out": ((B, T, D), "float32"),
                     "OutLength": ((B,), "int32")})
    ref = x.copy()
    ref[0, 2:] = 0
    _check(to["Out"], ref, 1e-6)
    x2 = RNG.standard_normal((B, D)).astype(np.float32)
    to, _ = op_pair("shrink_rnn_memory",
                    {"X": x2, "Length": np.array([3, 1], np.int32)},
                    {"step": 2}, {"Out": ((B, D), "float32")},
                    grad_slots=("X",))
    ref2 = x2.copy()
    ref2[1] = 0
    _check(to["Out"], ref2, 1e-6)


# ---------------------------------------------- the RNN cell/decoder API

def test_rnn_over_lstm_cell_matches_oracle_and_masks():
    B, T, D, H = 3, 5, 4, 6
    rng = np.random.default_rng(3)
    feed = {"x": rng.standard_normal((B, T, D)).astype(np.float32),
            "sl": np.array([5, 2, 4], np.int64)}
    cells = {}

    def build(fluid):
        L = fluid.layers
        x = L.data("x", [B, T, D], dtype="float32")
        sl = L.data("sl", [B], dtype="int64")
        cells[fluid] = cell = L.LSTMCell(H, name="rnnapi_lstm")
        outs, final = L.rnn(cell, x, sequence_length=sl)
        return [outs, final[0], final[1]]

    out, scopes, _ = run_pair(build, feed)
    assert_pair(out)
    ov, hv, _ = out["port"][0]
    cell = cells[tfluid]
    w = scopes["port"].find_var(cell._w.name).numpy()
    b = scopes["port"].find_var(cell._b.name).numpy()
    xv, lens = feed["x"], feed["sl"]
    for r in range(B):
        h = np.zeros(H, np.float32)
        c = np.zeros(H, np.float32)
        for t in range(T):
            if t < lens[r]:
                i, f, ch, o = np.split(np.concatenate([xv[r, t], h]) @ w + b,
                                       4)
                c = _sig(f + 1.0) * c + _sig(i) * np.tanh(ch)
                h = _sig(o) * np.tanh(c)
                np.testing.assert_allclose(ov[r, t], h, rtol=2e-4,
                                           atol=1e-5)
            else:
                np.testing.assert_allclose(ov[r, t], 0.0, atol=1e-6)
        np.testing.assert_allclose(hv[r], h, rtol=2e-4, atol=1e-5)


def test_basic_decoder_greedy_roundtrip():
    V, H, B = 6, 8, 2

    def build(fluid):
        L = fluid.layers
        emb_w = L.create_parameter([V, H], "float32", name="dec.emb")
        cell = L.GRUCell(H, name="dec_gru")
        proj_w = L.create_parameter([H, V], "float32", name="dec.proj")
        helper = L.GreedyEmbeddingHelper(
            lambda ids: L.gather(emb_w, L.reshape(ids, [-1])),
            start_tokens=L.fill_constant([B], "int64", 1), end_token=0)
        decoder = L.BasicDecoder(cell, helper,
                                 output_fn=lambda h: L.matmul(h, proj_w))
        init = cell.get_initial_states(
            L.fill_constant([B, 1], "float32", 0.0))
        (outs, ids), _ = L.dynamic_decode(decoder, inits=init,
                                          max_step_num=4)
        return [outs, ids]

    out, _, _ = run_pair(build)
    assert_pair(out)
    ov, iv = out["port"][0]
    assert ov.shape == (B, 4, V) and iv.shape == (B, 4)


def test_beam_search_decoder_decodes():
    V, H, B, beam = 7, 8, 2, 3

    def build(fluid):
        L = fluid.layers
        emb_w = L.create_parameter([V, H], "float32", name="bs.emb")
        proj_w = L.create_parameter([H, V], "float32", name="bs.proj")
        cell = L.GRUCell(H, name="bs_gru")
        decoder = L.BeamSearchDecoder(
            cell, start_token=1, end_token=0, beam_size=beam,
            embedding_fn=lambda ids: L.gather(emb_w, L.reshape(ids, [-1])),
            output_fn=lambda h: L.matmul(h, proj_w))
        init = cell.get_initial_states(
            L.fill_constant([B, 1], "float32", 0.0))
        (seqs, scores), _ = L.dynamic_decode(decoder, inits=init,
                                             max_step_num=5)
        return [seqs, scores]

    out, _, _ = run_pair(build)
    assert_pair(out)
    sv, scv = out["port"][0]
    assert sv.shape == (5, B, beam) and scv.shape == (B, beam)
    assert np.all(sv >= 0) and np.all(sv < V)
    assert np.all(np.diff(scv, axis=1) <= 1e-5)


def test_beam_search_breaks_ties_by_lower_index():
    """Equal scores rank by the lower flat index, as ``lax.top_k`` ranks
    them: every continuation of a beam of zero log-probs ties."""
    pre_ids = np.array([[1, 1]], np.int64)
    pre_scores = np.array([[0.0, 0.0]], np.float32)
    scores = np.zeros((2, 4), np.float32)
    to, _ = op_pair("beam_search", {"pre_ids": pre_ids,
                                    "pre_scores": pre_scores,
                                    "scores": scores},
                    {"beam_size": 2, "end_id": 0},
                    {"selected_ids": ((1, 2), "int32"),
                     "selected_scores": ((1, 2), "float32"),
                     "parent_idx": ((1, 2), "int32")})
    np.testing.assert_array_equal(to["selected_ids"], [[0, 1]])
    np.testing.assert_array_equal(to["parent_idx"], [[0, 0]])


def test_gather_tree_and_beam_search_decode():
    T, B, beam = 4, 2, 3
    rng = np.random.default_rng(11)
    ids = rng.integers(0, 9, (T, B, beam)).astype(np.int64)
    parents = rng.integers(0, beam, (T, B, beam)).astype(np.int64)
    scores = rng.standard_normal((T, B, beam)).astype(np.float32)
    to, _ = op_pair("gather_tree", {"Ids": ids, "Parents": parents}, {},
                    {"Out": ((T, B, beam), "int32")})
    ref = np.zeros((T, B, beam), np.int64)
    for b in range(B):
        for k in range(beam):
            p = k
            for t in range(T - 1, -1, -1):
                ref[t, b, k] = ids[t, b, p]
                p = parents[t, b, p]
    np.testing.assert_array_equal(to["Out"], ref)
    to, _ = op_pair("beam_search_decode",
                    {"Ids": ids, "ParentIdx": parents, "Scores": scores},
                    {}, {"SentenceIds": ((B, beam, T), "int32"),
                         "SentenceScores": ((B, beam), "float32")})
    np.testing.assert_array_equal(to["SentenceIds"], ref.transpose(1, 2, 0))


# ---------------------------------------------------- the book's models

def _fit_port(main, scope, feed, loss, losses, steps):
    exe = tfluid.Executor(tfluid.CPUPlace())
    while len(losses) < steps:
        losses.append(float(exe.run(main, feed=feed, fetch_list=[loss],
                                    scope=scope)[0]))
    assert np.isfinite(losses).all(), losses
    return losses


def test_understand_sentiment_lstm():
    """Embedding -> projected input -> full-sequence ``lstm`` op ->
    last-step ``sequence_pool`` -> classifier (book
    test_understand_sentiment)."""
    B, Tmax, V, E, H = 8, 12, 50, 16, 16
    rng = np.random.default_rng(0)
    words = rng.integers(1, V, (B, Tmax)).astype(np.int64)
    feed = {"words": words,
            "lens": rng.integers(4, Tmax + 1, (B,)).astype(np.int64),
            "label": (words[:, 0] % 2).astype(np.int64)[:, None]}
    prog = {}

    def build(fluid):
        L = fluid.layers
        w = L.data("words", [B, Tmax], dtype="int64")
        ln = L.data("lens", [B], dtype="int64")
        y = L.data("label", [B, 1], dtype="int64")
        proj = L.fc(L.embedding(w, size=[V, E]), 4 * H, num_flatten_dims=2)
        gb = fluid.default_main_program().global_block()
        weight = L.create_parameter([H, 4 * H], "float32")
        bias = L.create_parameter(
            [1, 4 * H], "float32",
            default_initializer=fluid.initializer.Constant(0.0))
        hidden = gb.create_var(name="lstm_hidden", dtype="float32",
                               shape=(B, Tmax, H))
        cell = gb.create_var(name="lstm_cell", dtype="float32",
                             shape=(B, Tmax, H))
        gb.append_op(type="lstm",
                     inputs={"Input": [proj.name], "Weight": [weight.name],
                             "Bias": [bias.name], "Length": [ln.name]},
                     outputs={"Hidden": [hidden.name], "Cell": [cell.name]},
                     attrs={}, infer_shape=False)
        last = L.sequence_pool(hidden, "last", length=ln)
        loss = L.mean(L.softmax_with_cross_entropy(L.fc(last, 2), y))
        fluid.optimizer.Adam(0.05).minimize(loss)
        prog["loss"] = loss
        return [loss]

    out, scopes, mains = run_pair(build, feed, steps=3)
    assert_pair(out)
    assert_scopes_close(scopes)
    ls = _fit_port(mains["port"], scopes["port"], feed, prog["loss"],
                   [float(x[0]) for x in out["port"]], 40)
    assert ls[-1] < 0.35 * ls[0], (ls[0], ls[-1])


def test_rnn_encoder_decoder():
    """GRU encoder -> GRU decoder with teacher forcing through the
    ``dynamic_gru`` layer (book test_rnn_encoder_decoder)."""
    B, Ts, Tt, V, H = 8, 6, 7, 40, 16
    rng = np.random.default_rng(4)
    tgt_in = rng.integers(1, V, (B, Tt)).astype(np.int64)
    feed = {"s": rng.integers(1, V, (B, Ts)).astype(np.int64),
            "ti": tgt_in, "to": np.roll(tgt_in, -1, axis=1)}
    prog = {}

    def build(fluid):
        L = fluid.layers
        s = L.data("s", [B, Ts], dtype="int64")
        ti = L.data("ti", [B, Tt], dtype="int64")
        to = L.data("to", [B, Tt], dtype="int64")
        enc = L.dynamic_gru(L.fc(L.embedding(s, size=[V, H]), 3 * H,
                                 num_flatten_dims=2), H)
        enc_last = L.sequence_last_step(
            enc, length=L.fill_constant([B], "int64", Ts))
        dec = L.dynamic_gru(L.fc(L.embedding(ti, size=[V, H]), 3 * H,
                                 num_flatten_dims=2), H, h_0=enc_last)
        logits = L.fc(dec, V, num_flatten_dims=2)
        loss = L.mean(L.softmax_with_cross_entropy(
            logits, L.unsqueeze(to, [2])))
        fluid.optimizer.Adam(5e-2).minimize(loss)
        prog["loss"] = loss
        return [loss]

    out, scopes, mains = run_pair(build, feed, steps=3)
    assert_pair(out)
    assert_scopes_close(scopes)
    ls = _fit_port(mains["port"], scopes["port"], feed, prog["loss"],
                   [float(x[0]) for x in out["port"]], 30)
    assert ls[-1] < 0.5 * ls[0], (ls[0], ls[-1])
