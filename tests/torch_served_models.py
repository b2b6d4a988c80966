"""Served programs shared by the port's io, inference and serving tests,
built the same way in either package (``pkg`` is ``paddle_tpu`` or
``paddle_tpu_torch``), at tiny widths:

- ``mlp``: x ``[-1, 16]`` -> fc 32 relu -> fc 4 softmax (bench.py's
  bench_serving recipe, narrowed);
- ``resnet``: ``resnet_train_program(depth=18, class_dim=4, 32x32,
  batch_size=-1)``, serving its logits;
- ``bert``: ``BertConfig.tiny()`` with flash attention, the encoder at
  ``is_test=True``, the [CLS] row through ``pooled_fc`` (tanh) and
  ``next_sent_fc`` with softmax, under ``bert_pretrain``'s parameter
  names; it serves the pooled row and the next-sentence probabilities.

``build(pkg, kind)`` returns ``(main, startup, feed_names, targets)``;
``feeds(kind, B, rng)`` makes a seeded request batch for it and
``weights(main, rng)`` seeded values of its persistables (positive
batch-norm variances), which a test sets into either package's scope
instead of compiling the startup program.
"""
import importlib

import numpy as np

S_BERT = 16
KINDS = ("mlp", "resnet", "bert")


def _mods(pkg):
    name = pkg.__name__
    return (importlib.import_module(f"{name}.models.resnet"),
            importlib.import_module(f"{name}.models.bert"),
            importlib.import_module(f"{name}.framework.initializer"))


def build(pkg, kind):
    resnet, bert, init = _mods(pkg)
    fluid = pkg
    main, startup = fluid.Program(), fluid.Program()
    with fluid.unique_name.guard(), fluid.program_guard(main, startup):
        if kind == "mlp":
            x = fluid.data("x", [-1, 16], "float32")
            h = fluid.layers.fc(x, 32, act="relu")
            return main, startup, ["x"], [fluid.layers.fc(h, 4,
                                                         act="softmax")]
        if kind == "resnet":
            out = resnet.resnet_train_program(
                depth=18, class_dim=4, image_shape=(3, 32, 32),
                batch_size=-1)
            return main, startup, ["image"], [out["logits"]]
        cfg = bert.BertConfig.tiny()
        cfg.attn_mechanism = "flash"
        names = ["src_ids", "sent_ids", "pos_ids", "input_mask"]
        src, sent, pos, mask = (
            fluid.data(n, [-1, S_BERT],
                       "float32" if n == "input_mask" else "int32")
            for n in names)
        enc, _ = bert.bert_encoder(cfg, src, sent, pos, mask, is_test=True)
        cls = fluid.layers.reshape(fluid.layers.slice(
            enc, axes=[1], starts=[0], ends=[1]), [-1, cfg.hidden_size])

        def attr(n, zero=False):
            return fluid.ParamAttr(
                name=n, initializer=init.Constant(0.0) if zero else
                init.TruncatedNormal(scale=cfg.initializer_range))

        pooled = fluid.layers.fc(cls, cfg.hidden_size,
                                 param_attr=attr("pooled_fc.w_0"),
                                 bias_attr=attr("pooled_fc.b_0", True),
                                 act="tanh")
        probs = fluid.layers.softmax(fluid.layers.fc(
            pooled, 2, param_attr=attr("next_sent_fc.w_0"),
            bias_attr=attr("next_sent_fc.b_0", True)))
        return main, startup, names, [pooled, probs]


def feeds(kind, B, rng):
    if kind == "mlp":
        return {"x": rng.standard_normal((B, 16)).astype(np.float32)}
    if kind == "resnet":
        return {"image": rng.standard_normal((B, 3, 32, 32))
                .astype(np.float32)}
    lens = rng.integers(S_BERT // 2, S_BERT + 1, (B, 1))
    return {
        "src_ids": rng.integers(0, 128, (B, S_BERT), dtype=np.int32),
        "sent_ids": rng.integers(0, 2, (B, S_BERT), dtype=np.int32),
        "pos_ids": np.broadcast_to(np.arange(S_BERT, dtype=np.int32),
                                   (B, S_BERT)).copy(),
        "input_mask": (np.arange(S_BERT) < lens).astype(np.float32),
    }


def weights(main, rng):
    """``{name: float32 array}`` for every persistable of ``main``."""
    out = {}
    for v in main.list_vars():
        if not v.persistable:
            continue
        a = rng.standard_normal(v.shape).astype(np.float32) * 0.1
        if v.name.endswith("_variance"):
            a = np.abs(a) * 10 + 0.5
        out[v.name] = a
    return out


def tolerance(kind):
    """Of max |ref|: float32 sums in another order (1e-5 for the MLP;
    1e-4 through ResNet's convolutions and BERT's layers)."""
    return 1e-5 if kind == "mlp" else 1e-4


def close(got, ref, kind):
    tol = tolerance(kind) * max(float(np.abs(ref).max()), 1e-30)
    return float(np.abs(np.asarray(got, np.float32) - ref).max()) <= tol
