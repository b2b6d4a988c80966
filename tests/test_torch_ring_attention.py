"""The port's ``ring_attention`` and ``ulysses_attention`` ops at sp 1
against the JAX package's, on the CPU, in this process.

At sp 1 (a program run as built) each op is one pass of exact
attention; its grads are the bespoke grad lowerings (the ring's from
the saved row log-sum-exp, Ulysses' the same formulas on its heads),
never the generic vjp. For each mechanism and each bias layout of the
JAX tests (none, a ``[B, 1, 1, S]`` padding mask, a ``[B, H, S, S]``
mask, a head-broadcast ``[B, 1, S, S]`` causal mask, ``causal=True``,
and a finite key bias whose grad is read) the port's out and the grads
of q, k and v (and the bias) equal the JAX package's op and
``_naive_ref`` of ``tests/test_ring_attention.py`` within the JAX
test's own rtol 2e-5 / atol 1e-5. ``test_torch_sequence_parallel.py``
holds the split ops on four gloo ranks.
"""
import numpy as np
import pytest

import paddle_tpu as jfluid
import paddle_tpu_torch as tfluid
from paddle_tpu_torch.framework import registry as tregistry

import torch_sp_runner as R

B, H, S, D = R.B, R.H, R.S, R.D


def _naive_ref(q, k, v, bias=None, causal=False):
    s = np.einsum("bhqd,bhkd->bhqk", q, k) / np.sqrt(D)
    if bias is not None:
        s = s + bias
    if causal:
        s = s + np.triu(np.full((S, S), -1e30, np.float32), k=1)
    s = s - s.max(-1, keepdims=True)
    p = np.exp(s)
    p = p / p.sum(-1, keepdims=True)
    return np.einsum("bhqk,bhkd->bhqd", p, v)


def _run(fluid, mech, bias, causal, bias_grad, place=None):
    main, startup = fluid.Program(), fluid.Program()
    with fluid.unique_name.guard(), fluid.program_guard(main, startup):
        out, grads = R.build_attention(fluid, mech, R.BIAS_SHAPES[bias],
                                       causal, bias_grad=bias_grad)
    exe = fluid.Executor(place) if place is not None else fluid.Executor()
    scope = fluid.Scope()
    exe.run(startup, scope=scope)
    vals = exe.run(main, feed=R.attention_feed(bias),
                   fetch_list=[out] + list(grads), scope=scope)
    return main, [np.asarray(v) for v in vals]


CASES = [("none", None, False, False), ("key", "key", False, False),
         ("full", "full", False, False),
         ("causal_bias", "causal", False, False),
         ("causal_flag", None, True, False),
         ("bias_grad", "soft", False, True),
         ("bias_grad_causal", "soft", True, True)]


@pytest.mark.parametrize("mech", ["ring", "ulysses"])
@pytest.mark.parametrize("name,bias,causal,bias_grad", CASES,
                         ids=[c[0] for c in CASES])
def test_op_and_grads_equal_jax_at_sp1(mech, name, bias, causal,
                                       bias_grad):
    _, want = _run(jfluid, mech, bias, causal, bias_grad)
    main, got = _run(tfluid, mech, bias, causal, bias_grad,
                     tfluid.CPUPlace())
    assert len(got) == len(want) == 4 + bias_grad
    for tag, a, b in zip(("out", "gq", "gk", "gv", "gbias"), got, want):
        np.testing.assert_allclose(a, b, rtol=2e-5, atol=1e-5,
                                   err_msg=f"{mech} {name} {tag}")
    f = R.attention_feed(bias)
    ref = _naive_ref(f["q"], f["k"], f["v"], f.get("bias"), causal)
    np.testing.assert_allclose(got[0], ref, rtol=2e-5, atol=1e-5)
    # the grad op is the op's own lowering, not the generic vjp
    types = [op.type for op in main.global_block().ops]
    assert f"{mech}_attention_grad" in types
    assert tregistry.OPS[f"{mech}_attention"].custom_grad_lower is not None


@pytest.mark.parametrize("mech", ["ring", "ulysses"])
def test_grad_without_a_saved_forward_runs_it_again(mech):
    """The grad op alone (its forward ran in another run): it recomputes
    the forward and gives the same grads as with the saved one."""
    import torch
    from paddle_tpu_torch.framework.lowering import LowerCtx
    f = R.attention_feed("soft")
    ins = {k.upper() if k != "bias" else "Bias":
           [torch.from_numpy(v)] for k, v in f.items()}
    ctx = LowerCtx(None, None, {}, "cpu")
    opdef = tregistry.get_op_def(f"{mech}_attention")
    out = opdef.lower(ctx, ins, {"causal": True})["Out"]
    dout = torch.from_numpy(np.random.default_rng(5).standard_normal(
        out.shape).astype(np.float32))
    attrs = {"__fwd_op__": {"type": f"{mech}_attention",
                            "inputs": {}, "outputs": {"Out": ["o"]},
                            "attrs": {"causal": True}},
             "__grad_inputs__": {"Q": [True], "K": [True], "V": [True],
                                 "Bias": [True]}}
    grads = tregistry.get_op_def(f"{mech}_attention_grad").lower(
        ctx, dict(ins, **{"Out@GRAD": [dout]}), attrs)
    leaves = {k: v[0].clone().requires_grad_(True) for k, v in ins.items()}
    ref = _torch_ref(leaves, causal=True)
    ref.backward(dout)
    for slot in ("Q", "K", "V", "Bias"):
        torch.testing.assert_close(grads[slot + "@GRAD"][0],
                                   leaves[slot].grad, rtol=2e-5,
                                   atol=1e-5)


def _torch_ref(t, causal):
    import torch
    s = torch.einsum("bhqd,bhkd->bhqk", t["Q"], t["K"]) / D ** 0.5
    s = s + t["Bias"]
    s = s.masked_fill(~torch.ones(S, S, dtype=torch.bool).tril(), -1e30)
    return torch.einsum("bhqk,bhkd->bhqd", s.softmax(-1), t["V"])


def test_bias_layouts_other_than_the_three_raise():
    import torch
    from paddle_tpu_torch.framework.lowering import LowerCtx
    f = R.attention_feed()
    ins = {k.upper(): [torch.from_numpy(v)] for k, v in f.items()}
    ins["Bias"] = [torch.zeros(B, 1, S)]
    with pytest.raises(ValueError, match="Bias must be"):
        tregistry.get_op_def("ring_attention").lower(
            LowerCtx(None, None, {}, "cpu"), ins, {})
