"""The port's repaired faults, on the CPU.

- The ``flash_attention`` op routes a bias that is not a ``[B, 1, 1, Sk]``
  key bias to the plain composite with the bias detached when ``impl``
  is "", as the JAX op does; its output and grads match the JAX op's
  (rtol 1e-5, atol 1e-6 in float32), the bias grad is zero, and an
  explicit kernel request raises the JAX message.
- The kernel wrappers accept head dim 16 (K5) and 80 / 96 (K1-K4) up to
  the kernel launch, refuse other head dims with a message that names
  the supported ones, and list exactly the head dims the CUDA dispatch
  switches instantiate.

- ``slice`` squeezes its ``decrease_axis`` as the JAX op does
  (``[2,3,4,5]``, axes [1], starts [1], ends [2], decrease_axis [1]
  gives ``[2,4,5]``, the same values).
- Paddle ``VarType`` enum ints as a dtype attr: ``cast`` (``out_dtype``
  0, 2, 3), ``fill_constant`` (``dtype`` 0, 3, 5) and ``fill_any_like``
  (``dtype`` 3) run and give the JAX op's values and dtype (the JAX
  package stores int64 as int32, x64 being off; the port keeps int64),
  and ``dtype_to_proto_enum`` inverts the table.

The kernels themselves run only on the GPU (chip_smoke.py holds them
against their plain versions there)."""
import importlib
import os
import re

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from paddle_tpu.ops import ring_attention_ops  # noqa: F401  (registers)
from paddle_tpu.framework import registry as jregistry

from paddle_tpu.framework import lowering as jlowering
from paddle_tpu.framework.dtype import dtype_to_proto_enum as jenum

from paddle_tpu_torch.framework import registry as tregistry
from paddle_tpu_torch.framework.dtype import convert_dtype, \
    dtype_to_proto_enum
from paddle_tpu_torch.framework.lowering import LowerCtx
from paddle_tpu_torch.ops import attention_ops

# the modules (the package exports functions of the same names)
tfa = importlib.import_module("paddle_tpu_torch.kernels.flash_attention")
tpa = importlib.import_module("paddle_tpu_torch.kernels.paged_attention")

CSRC = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))), "paddle_tpu_torch", "kernels", "csrc")


def _qkvb(rng, B, H, Sq, Sk, D, bias_shape):
    f = lambda *s: rng.normal(size=s).astype(np.float32)  # noqa: E731
    bias = np.where(rng.random(bias_shape) > 0.3, 0.0, -1e4).astype(
        np.float32)
    return f(B, H, Sq, D), f(B, H, Sk, D), f(B, H, Sk, D), bias


def _port_op(ins, attrs):
    ctx = LowerCtx(None, None, {}, "cpu")
    return tregistry.get_op_def("flash_attention").lower(ctx, ins, attrs)


@pytest.mark.parametrize("causal", [False, True])
def test_general_bias_takes_the_composite_like_jax(causal, monkeypatch):
    rng = np.random.default_rng(3)
    q, k, v, bias = _qkvb(rng, 2, 3, 8, 8, 16, (2, 3, 8, 8))
    attrs = {"causal": causal, "impl": ""}
    dout = rng.normal(size=q.shape).astype(np.float32)

    def jfn(q, k, v, bias):
        out = jregistry.get_op_def("flash_attention").lower(
            None, {"Q": [q], "K": [k], "V": [v], "Bias": [bias]}, attrs)
        return out["Out"] if isinstance(out["Out"], jax.Array) \
            else out["Out"][0]
    jout, vjp = jax.vjp(jfn, *map(jnp.asarray, (q, k, v, bias)))
    jgrads = vjp(jnp.asarray(dout))

    def kernel_path(*a, **kw):
        raise AssertionError("a general bias reached the kernel path")
    monkeypatch.setattr(attention_ops, "flash_attention_train", kernel_path)
    tq, tk, tv, tb = (torch.from_numpy(a).requires_grad_()
                      for a in (q, k, v, bias))
    tout = _port_op({"Q": [tq], "K": [tk], "V": [tv], "Bias": [tb]},
                    attrs)["Out"]
    tout.backward(torch.from_numpy(dout))
    np.testing.assert_allclose(tout.detach().numpy(), np.asarray(jout),
                               rtol=1e-5, atol=1e-6)
    for t, g in zip((tq, tk, tv), jgrads):
        np.testing.assert_allclose(t.grad.numpy(), np.asarray(g),
                                   rtol=1e-5, atol=1e-6)
    assert tb.grad is None or not tb.grad.any()
    assert not np.asarray(jgrads[3]).any()


def test_key_bias_takes_the_kernel_path(monkeypatch):
    rng = np.random.default_rng(4)
    q, k, v, bias = _qkvb(rng, 2, 3, 8, 8, 16, (2, 1, 1, 8))
    called = []

    def kernel_path(*a, **kw):
        called.append(a[3].shape)
        return tfa.flash_attention_train(*a, **kw)
    monkeypatch.setattr(attention_ops, "flash_attention_train", kernel_path)
    _port_op({s: [torch.from_numpy(a)] for s, a in
              zip(("Q", "K", "V", "Bias"), (q, k, v, bias))},
             {"causal": True, "impl": ""})
    assert called == [(2, 1, 1, 8)]


def test_explicit_kernel_request_refuses_a_general_bias():
    rng = np.random.default_rng(5)
    ins = {s: [torch.from_numpy(a)] for s, a in zip(
        ("Q", "K", "V", "Bias"), _qkvb(rng, 1, 2, 4, 4, 16, (1, 2, 4, 4)))}
    with pytest.raises(ValueError, match=r"\[B, 1, 1, Sk\] key bias.*"
                                         r"impl='xla'"):
        _port_op(ins, {"impl": "pallas"})
    with pytest.raises(ValueError, match="is not in paddle_tpu_torch"):
        _port_op(ins, {"impl": "mosaic"})


# -- head dims --------------------------------------------------------------

def _switch_cases(source, func):
    """The ``case N:`` labels of function ``func``'s switch in a source."""
    with open(os.path.join(CSRC, source)) as f:
        text = f.read()
    body = text[text.index(func):]
    body = body[:body.index("default:")]
    return tuple(sorted(int(c) for c in re.findall(r"case (\d+):", body)))


def test_wrapper_head_dims_are_the_dispatch_switches():
    assert tfa._HEAD_DIMS == _switch_cases("flash_attention_fwd.cu",
                                           "cudaError_t dispatch_d")
    assert tfa._HEAD_DIMS == _switch_cases("flash_attention_bwd.cu",
                                           "cudaError_t dispatch_d")
    assert tpa._HEAD_DIMS == _switch_cases("paged_attention.cu",
                                           "cudaError_t dispatch_d")


@pytest.mark.parametrize("D", [16, 32, 64, 80, 96, 128])
def test_flash_wrapper_accepts_head_dim(D):
    q = torch.zeros(2, 3, 40, D)
    tfa._check(q, q, q, torch.zeros(2, 1, 1, 40))       # no raise


@pytest.mark.parametrize("D", [8, 48, 112, 256])
def test_flash_wrapper_refuses_other_head_dims(D):
    q = torch.zeros(2, 3, 40, D)
    with pytest.raises(ValueError, match=r"\(16, 32, 64, 80, 96, 128\).*"
                                         r"impl=\"xla\""):
        tfa._check(q, q, q, None)


@pytest.mark.parametrize("D", [16, 32, 64, 128])
def test_paged_wrapper_accepts_head_dim(D):
    B, H, bs, nblk = 2, 3, 16, 4
    q = torch.zeros(B, H, 1, D)
    pool = torch.zeros(9, H, bs, D, dtype=torch.int8)
    scales = torch.ones(9, H, bs)
    tables = torch.ones(B, nblk, dtype=torch.int32)
    pos = torch.tensor([5, 40], dtype=torch.int32)
    tpa._check(q, pool, pool, tables, pos, scales, scales)   # no raise
    with pytest.raises(ValueError, match="head dim"):
        tpa._check(q[..., :8], pool[..., :8], pool[..., :8], tables, pos,
                   scales, scales)


def test_plain_versions_take_d80():
    """On CPU tensors the wrappers take their plain versions at any
    head dim; at D80 forward and backward match a float64 autograd
    reference (rtol 1e-4)."""
    rng = np.random.default_rng(6)
    q, k, v = (torch.from_numpy(rng.normal(size=(1, 2, 24, 80)).astype(
        np.float32)) for _ in range(3))
    out, lse = tfa.flash_attention_fwd(q, k, v, causal=True)
    dout = torch.from_numpy(rng.normal(size=out.shape).astype(np.float32))
    dq, dk, dv = tfa.flash_attention_bwd(q, k, v, None, None, True, out,
                                         lse, dout)
    q64, k64, v64 = (t.double().requires_grad_() for t in (q, k, v))
    s = q64 @ k64.transpose(-1, -2) * 80 ** -0.5
    s = s.masked_fill(~torch.ones(24, 24, dtype=torch.bool).tril(),
                      float("-inf"))
    ref = torch.softmax(s, -1) @ v64
    ref.backward(dout.double())
    np.testing.assert_allclose(out.numpy(), ref.detach().numpy(), rtol=1e-4,
                               atol=1e-5)
    for a, b in ((dq, q64), (dk, k64), (dv, v64)):
        np.testing.assert_allclose(a.numpy(), b.grad.numpy(), rtol=1e-4,
                                   atol=1e-5)


def _both_ops(op_type, ins, attrs):
    """(JAX output, port output) of one op's lowering on the same numpy
    inputs, as numpy arrays."""
    jctx = jlowering.LowerCtx(None, None, {}, jax.random.PRNGKey(0))
    jout = jregistry.get_op_def(op_type).lower(
        jctx, {k: [jnp.asarray(a) for a in v] for k, v in ins.items()},
        attrs)["Out"]
    tout = tregistry.get_op_def(op_type).lower(
        LowerCtx(None, None, {}, "cpu"),
        {k: [torch.from_numpy(a) for a in v] for k, v in ins.items()},
        attrs)["Out"]
    jout = jout[0] if isinstance(jout, list) else jout
    tout = tout[0] if isinstance(tout, list) else tout
    return np.asarray(jout), tout.numpy()


def test_slice_decrease_axis_squeezes_like_jax():
    x = np.random.default_rng(4).normal(size=(2, 3, 4, 5)).astype(np.float32)
    attrs = {"axes": [1], "starts": [1], "ends": [2], "decrease_axis": [1]}
    j, t = _both_ops("slice", {"Input": [x]}, attrs)
    assert j.shape == t.shape == (2, 4, 5)
    np.testing.assert_array_equal(t, j)
    j, t = _both_ops("slice", {"Input": [x]}, dict(attrs, decrease_axis=[]))
    assert j.shape == t.shape == (2, 1, 4, 5)


# (op, its inputs, its attrs): every dtype attr a VarType enum int
ENUM_CASES = {
    "cast_bool": ("cast", "x", {"out_dtype": 0}),
    "cast_int32": ("cast", "x", {"out_dtype": 2}),
    "cast_int64": ("cast", "x", {"out_dtype": 3}),
    "fill_constant_bool": ("fill_constant", None,
                           {"shape": [2, 3], "dtype": 0, "value": 1.0}),
    "fill_constant_int64": ("fill_constant", None,
                            {"shape": [2, 3], "dtype": 3, "value": 7.0}),
    "fill_constant_float32": ("fill_constant", None,
                              {"shape": [4, 5], "dtype": 5, "value": 0.5}),
    "fill_any_like_int64": ("fill_any_like", "x",
                            {"dtype": 3, "value": 3.0}),
}
# the JAX package narrows int64 to int32 (x64 off); the port keeps it
NARROWED = {"int64": "int32"}


@pytest.mark.parametrize("case", sorted(ENUM_CASES))
def test_vartype_enum_dtypes_run_like_jax(case):
    op_type, inp, attrs = ENUM_CASES[case]
    x = np.random.default_rng(5).normal(size=(2, 3)).astype(np.float32) * 3
    j, t = _both_ops(op_type, {"X": [x]} if inp else {}, attrs)
    key = "out_dtype" if op_type == "cast" else "dtype"
    want = convert_dtype(attrs[key])
    assert str(t.dtype) == want
    assert NARROWED.get(want, want) == str(j.dtype)
    np.testing.assert_array_equal(t, j.astype(t.dtype))


def test_dtype_enum_table_is_jax():
    for name in ("bool", "int16", "int32", "int64", "float16", "float32",
                 "float64", "uint8", "int8", "bfloat16"):
        assert dtype_to_proto_enum(name) == jenum(name)
        assert convert_dtype(dtype_to_proto_enum(name)) == name
