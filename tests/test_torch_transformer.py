"""The port's dygraph Transformer (``models/transformer.py``, BASELINE
config 5 at a small size) against the JAX package's, on the CPU.

2+2 layers, d_model 32, 4 heads, d_inner 64, vocab 64, B4, src 8, tgt 6,
each source row's tail padded, dropout 0. A fresh port model's
``state_dict`` equals a fresh JAX one bitwise (the numpy init stream);
the loss is within rel 1e-5 of JAX's; every parameter grad is within
1e-4 of its max |ref|; after 3 Adam steps by the port's ``jit_step`` the
losses are within rtol 2e-4 and every parameter within 1e-4 of its max
|ref| of JAX's eager steps. In the port, ``jit_step`` calls equal eager
steps under the same run-seed protocol bitwise, dropout on or off. The
dygraph BERT's counterpart is ``test_torch_bert_dygraph.py`` (each
model's first JAX eager pass compiles every op, ~20 s apiece)."""
import numpy as np
import pytest

import paddle_tpu as jfluid
from paddle_tpu import dygraph as jdy
from paddle_tpu.dygraph import layers as jdylayers
from paddle_tpu.models import transformer as jtr

import paddle_tpu_torch as tfluid
from paddle_tpu_torch import dygraph as tdy
from paddle_tpu_torch.dygraph import layers as tdylayers
from paddle_tpu_torch.models import transformer as ttr

CPU = tfluid.CPUPlace()
V, B, S, T = 64, 4, 8, 6
TR_KEYS = ("src_ids", "src_mask", "tgt_ids", "labels", "label_mask")


def _tr_batch():
    batch = jtr.random_batch(B, S, T, V, V, rng=np.random.default_rng(0))
    for i, n in enumerate((8, 6, 5, 3)):      # padded source tails
        batch["src_mask"][i, n:] = 0
    batch["label_mask"][1, 4:] = 0
    return batch


def _transformer(tr):
    return tr.Transformer(V, V, d_model=32, n_head=4, d_inner=64,
                          n_layer=2, max_len=16, dropout=0.0)


def _run(pkg, build, batch, keys, steps=3, seed=3):
    """(fresh state_dict, step-0 loss, step-0 grads, per-step losses of
    `steps` Adam steps, final state_dict): eager in the JAX package, by
    jit_step in the port (whose first call is its eager warm-up)."""
    fluid, dy, dylayers = pkg
    guard = dy.guard(CPU) if dy is tdy else dy.guard()
    with guard:
        dylayers.set_init_seed(seed)
        model = build()
        fresh = model.state_dict()
        args = [dy.to_variable(batch[k]) for k in keys]
        loss = model(*args)
        loss.backward()
        grads = {n: p.gradient() for n, p in model.named_parameters()}
        loss0 = float(loss.numpy().reshape(-1)[0])
        model.clear_gradients()
        opt = fluid.optimizer.Adam(1e-3, parameter_list=model.parameters())

        def step(*a):
            out = model(*a)
            out.backward()
            opt.minimize(out)
            model.clear_gradients()
            return out

        if dy is tdy:
            step = dy.jit_step(step)
        losses = [float(step(*args).numpy().reshape(-1)[0])
                  for _ in range(steps)]
        return fresh, loss0, grads, losses, model.state_dict()


def _check(ref, got, param_scale=None):
    """``param_scale``: compare the trained parameters against this
    scale instead of each one's own max |ref|."""
    fresh_j, loss_j, grads_j, losses_j, final_j = ref
    fresh_t, loss_t, grads_t, losses_t, final_t = got
    assert sorted(fresh_t) == sorted(fresh_j)
    for k in fresh_j:
        np.testing.assert_array_equal(fresh_t[k], fresh_j[k])
    assert abs(loss_t - loss_j) <= 1e-5 * abs(loss_j)
    assert sorted(grads_t) == sorted(grads_j)
    for n, g in grads_j.items():
        err = np.abs(grads_t[n] - g).max()
        assert err <= 1e-4 * max(np.abs(g).max(), 1e-30), (n, err)
    np.testing.assert_allclose(losses_t, losses_j, rtol=2e-4, atol=1e-6)
    for k, v in final_j.items():
        scale = np.abs(v).max() if param_scale is None else param_scale
        assert np.abs(final_t[k] - v).max() <= 1e-4 * scale, k


def test_transformer_matches_jax():
    batch = _tr_batch()
    ref = _run((jfluid, jdy, jdylayers), lambda: _transformer(jtr), batch,
               TR_KEYS)
    got = _run((tfluid, tdy, tdylayers), lambda: _transformer(ttr), batch,
               TR_KEYS)
    _check(ref, got)
    assert got[3][-1] < got[3][0]


@pytest.mark.parametrize("dropout", [0.0, 0.1])
def test_transformer_jit_step_equals_eager_bitwise(dropout):
    """In the port, 3 jit_step calls end bitwise where 3 eager steps under
    the same run-seed protocol end (``CompiledStep.eager``)."""
    batch = _tr_batch()
    finals = []
    for compiled in (False, True):
        with tdy.guard(CPU):
            tdylayers.set_init_seed(4)
            model = ttr.Transformer(V, V, d_model=32, n_head=4, d_inner=64,
                                    n_layer=1, max_len=16, dropout=dropout)
            opt = tfluid.optimizer.Adam(1e-3,
                                        parameter_list=model.parameters())

            @tdy.jit_step
            def step(*a):
                out = model(*a)
                out.backward()
                opt.minimize(out)
                model.clear_gradients()
                return out

            args = [tdy.to_variable(batch[k]) for k in TR_KEYS]
            step(*args)                 # the eager warm-up either way
            run = step if compiled else step._compiled_step.eager
            losses = [run(*args).numpy() for _ in range(3)]
            finals.append((losses, model.state_dict()))
    (le, se), (lc, sc) = finals
    for a, b in zip(le, lc):
        np.testing.assert_array_equal(a, b)
    for k in se:
        np.testing.assert_array_equal(se[k], sc[k])
