"""The port's dygraph BERT (``models/bert_dygraph.py``) against the JAX
package's ``bert_dygraph``, on the CPU: a tiny config with dropout 0
through ``test_torch_transformer.py``'s checks (the fresh ``state_dict``
bitwise, the loss within rel 1e-5, every grad within 1e-4 of its max
|ref|, 3 Adam steps by the port's ``jit_step`` against JAX's eager steps:
losses within rtol 2e-4), and the parameter census of the static
``bert_pretrain``.

The trained parameters are held within 1e-4 of the model's max |ref|
(the largest parameter value) rather than each one's own: a few grad
elements of this model are near zero by cancellation (the key third of
the fused qkv bias is exactly zero in exact arithmetic: softmax ignores a
per-query constant), so both packages' fp32 grads there are rounding
noise, which Adam's normalised update turns into steps of up to lr in
either direction."""
import numpy as np

import paddle_tpu as jfluid
from paddle_tpu import dygraph as jdy
from paddle_tpu.dygraph import layers as jdylayers
from paddle_tpu.models import bert as jbert
from paddle_tpu.models import bert_dygraph as jbert_dy

import paddle_tpu_torch as tfluid
from paddle_tpu_torch import dygraph as tdy
from paddle_tpu_torch.dygraph import layers as tdylayers
from paddle_tpu_torch.models import bert as tbert
from paddle_tpu_torch.models import bert_dygraph as tbert_dy

from test_torch_transformer import _check, _run

BERT_KEYS = ("src_ids", "sent_ids", "pos_ids", "input_mask", "mask_pos",
             "mask_label", "labels")


def _bert(cfg_cls, mod):
    cfg = cfg_cls.tiny()
    cfg.hidden_dropout = cfg.attn_dropout = 0.0
    return mod.BertPretrainDy(cfg)


def test_bert_dygraph_matches_jax():
    feed = jbert.random_batch(jbert.BertConfig.tiny(), 4, 16, 3,
                              rng=np.random.default_rng(1))
    ref = _run((jfluid, jdy, jdylayers),
               lambda: _bert(jbert.BertConfig, jbert_dy), feed, BERT_KEYS)
    got = _run((tfluid, tdy, tdylayers),
               lambda: _bert(tbert.BertConfig, tbert_dy), feed, BERT_KEYS)
    _check(ref, got, param_scale=max(np.abs(v).max()
                                     for v in ref[4].values()))
    # the parameter census of the static graph (same architecture)
    cfg = tbert.BertConfig.tiny()
    main, startup = tfluid.Program(), tfluid.Program()
    with tfluid.program_guard(main, startup):
        tbert.bert_pretrain(cfg, 4, 16, 3)
    n_static = sum(1 for v in main.global_block().vars.values()
                   if getattr(v, "is_parameter", False))
    assert len(got[2]) == n_static
