"""One program built in both packages and run on the same seeded inputs,
for the port's control-flow, sequence and RNN tests
(``test_torch_control_flow.py``, ``test_torch_sequence_ops.py``,
``test_torch_rnn_ops.py``).

``run_pair(build, feed, steps)``: ``build(fluid)`` builds a program
with either package's ``fluid`` (under ``unique_name.guard``, so both
name their vars alike) and returns the vars to fetch; both run their
startup, the port's scope takes the JAX startup's values
(``scope_from_arrays``), and each runs ``steps`` times on ``feed``.
``run_op(op_type, inputs, attrs, outputs, grad_slots)``: one op over fed
inputs in either package, with the grads of ``sum(out * cot)`` for a
seeded cotangent, as ``test_torch_conv.py`` runs its ops. Tolerances:
forward values within 1e-5 of max |ref|, grads within 1e-4."""
import numpy as np

import paddle_tpu as jfluid

import paddle_tpu_torch as tfluid
from paddle_tpu_torch.framework.executor import scope_from_arrays

JAX_RNG = "@RNG_KEY@"
FWD_TOL, GRAD_TOL = 1e-5, 1e-4


def arrays(jscope):
    return {n: np.array(v) for n, v in jscope.items() if n != JAX_RNG}


def _exe(fluid):
    return fluid.Executor() if fluid is jfluid else \
        fluid.Executor(fluid.CPUPlace())


def _np(v):
    return np.asarray(v)


def run_pair(build, feed=None, steps=1):
    """({"jax": [per-step fetch lists], "port": [...]}, {"jax": scope,
    "port": scope}, {"jax": main program, "port": ...}) of ``build``'s
    program in both packages."""
    out, scopes, mains, start = {}, {}, {}, None
    for pkg, fluid in (("jax", jfluid), ("port", tfluid)):
        main, startup = fluid.Program(), fluid.Program()
        main.random_seed = startup.random_seed = 7
        with fluid.unique_name.guard(), fluid.program_guard(main, startup):
            fetch = build(fluid)
        exe, scope = _exe(fluid), fluid.Scope()
        exe.run(startup, scope=scope)
        if pkg == "jax":
            start = arrays(scope)
        else:
            scope_from_arrays(scope, start)
        out[pkg] = [[_np(v) for v in exe.run(main, feed=feed or {},
                                             fetch_list=fetch, scope=scope)]
                    for _ in range(steps)]
        scopes[pkg], mains[pkg] = scope, main
    return out, scopes, mains


def rel_err(got, want):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    assert got.shape == want.shape, (got.shape, want.shape)
    if want.size == 0:
        return 0.0
    return float(np.abs(got - want).max()) / max(float(np.abs(want).max()),
                                                 1e-30)


def assert_close(got, want, tol, what):
    err = rel_err(got, want)
    assert err <= tol, f"{what}: max |port - jax| / max |jax| = {err:.3g}"


def assert_pair(out, tols=None, what=""):
    """Every fetch of every step of the port within its tolerance (1e-5
    of max |ref| by default; an int or bool fetch exactly) of JAX's."""
    for k, (js, ts) in enumerate(zip(out["jax"], out["port"])):
        for i, (j, t) in enumerate(zip(js, ts)):
            if np.asarray(j).dtype.kind in "biu":
                assert np.array_equal(t, j), f"{what} step {k} fetch {i}"
            else:
                assert_close(t, j, (tols or {}).get(i, FWD_TOL),
                             f"{what} step {k} fetch {i}")


def assert_scopes_close(scopes, rtol=1e-5, atol=1e-5):
    """Every var of the JAX scope in the port's within rtol/atol."""
    for name, want in arrays(scopes["jax"]).items():
        np.testing.assert_allclose(scopes["port"].find_var(name).numpy(),
                                   want, rtol=rtol, atol=atol, err_msg=name)


def run_op(pkg, op_type, inputs, attrs, outputs, grad_slots=(),
           grad_of=None, seed=0):
    """One ``op_type`` op over data vars fed ``inputs`` ({slot: array or
    [(name, array), ...]}), declaring ``outputs`` ({slot: (shape,
    dtype)}, or a list of them for a slot of several vars). Returns
    ({output slot: array, or a list for a listed slot}, {grad slot:
    array}); the grads are of sum(out[grad_of] * cot) for a seeded
    cotangent (``grad_of`` defaults to the first output; its first var
    for a listed slot)."""
    fluid = jfluid if pkg == "jax" else tfluid
    L = fluid.layers
    main, startup = fluid.Program(), fluid.Program()
    feed, leaves = {}, {}
    with fluid.unique_name.guard(), fluid.program_guard(main, startup):
        block = main.global_block()
        ins = {}
        for slot, a in inputs.items():
            pairs = a if isinstance(a, list) else [(f"in_{slot.lower()}",
                                                    a)]
            vs = []
            for name, arr in pairs:
                vs.append(L.data(name, list(arr.shape), str(arr.dtype),
                                 stop_gradient=slot not in grad_slots))
                feed[name] = arr
            ins[slot] = vs
            leaves[slot] = vs[0]
        outs = {}
        for s, spec in outputs.items():
            specs = spec if isinstance(spec, list) else [spec]
            outs[s] = [block.create_var(name=f"out_{s.lower()}_{k}",
                                        shape=shape, dtype=dt)
                       for k, (shape, dt) in enumerate(specs)]
        block.append_op(type=op_type, inputs=ins, outputs=outs,
                        attrs=attrs, infer_shape=False)
        grads = []
        if grad_slots:
            y = outs[grad_of or next(iter(outputs))][0]
            cot = np.random.default_rng(seed + 99).standard_normal(
                y.shape).astype(np.float32)
            c = L.data("cot", list(cot.shape), "float32")
            feed["cot"] = cot
            loss = L.reduce_sum(L.elementwise_mul(y, c))
            grads = fluid.gradients([loss], [leaves[s] for s in grad_slots])
    flat = [v for s in outputs for v in outs[s]]
    vals = [_np(v) for v in _exe(fluid).run(main, feed=feed,
                                            fetch_list=flat + grads)]
    got, it = {}, iter(vals[:len(flat)])
    for s, spec in outputs.items():
        got[s] = [next(it) for _ in spec] if isinstance(spec, list) \
            else next(it)
    return got, dict(zip(grad_slots, vals[len(flat):]))


def op_pair(op_type, inputs, attrs, outputs, grad_slots=(), grad_of=None):
    """:func:`run_op` in both packages, the port's outputs and grads held
    to JAX's (ints exact, floats within 1e-5 / grads 1e-4 of max |ref|).
    Returns the port's (outputs, grads)."""
    jo, jg = run_op("jax", op_type, inputs, attrs, outputs, grad_slots,
                    grad_of)
    to, tg = run_op("port", op_type, inputs, attrs, outputs, grad_slots,
                    grad_of)
    for s in outputs:
        pairs = zip(to[s], jo[s]) if isinstance(outputs[s], list) \
            else [(to[s], jo[s])]
        for t, j in pairs:
            if j.dtype.kind in "biu":
                assert np.array_equal(t, j), f"{op_type} {s}"
            else:
                assert_close(t, j, FWD_TOL, f"{op_type} {s}")
    for s in grad_slots:
        assert_close(tg[s], jg[s], GRAD_TOL, f"{op_type} {s}@GRAD")
    return to, tg
