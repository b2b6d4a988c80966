"""The port's ``switch_moe`` op and layer, and the ``alltoall`` op, against
the JAX package on the CPU (``paddle_tpu/ops/moe_ops.py``,
``tests/test_moe.py``).

The op runs in both packages on the same seeded inputs, each of its six
inputs fed as a data var, and the grads of ``sum(Out * cot) + a *
AuxLoss`` for a seeded cotangent come from ``fluid.gradients``: Out,
AuxLoss and the six grads within 1e-5 of max |ref| (float32), with
overflowing capacity, with C = 1 (JAX's
``test_moe_capacity_drops_overflow``), and with every token's gate
tied. In a world of one the ``alltoall`` op is the identity, as JAX's
outside a mapped axis; its block order is checked against numpy on the
gloo ranks of ``test_torch_expert_parallel.py``."""
import numpy as np
import pytest

import paddle_tpu as jfluid

import paddle_tpu_torch as tfluid

from torch_pair import arrays, assert_close, run_pair

SLOTS = ("X", "GateW", "W1", "B1", "W2", "B2")
TOL = 1e-5
AUX_W = 0.37


def inputs(N=32, D=8, E=4, H=16, seed=0, gate_scale=1.0):
    rng = np.random.default_rng(seed)
    f = np.float32
    return {"X": rng.standard_normal((N, D)).astype(f),
            "GateW": (gate_scale * rng.standard_normal((D, E))).astype(f),
            "W1": (0.3 * rng.standard_normal((E, D, H))).astype(f),
            "B1": (0.1 * rng.standard_normal((E, H))).astype(f),
            "W2": (0.3 * rng.standard_normal((E, H, D))).astype(f),
            "B2": (0.1 * rng.standard_normal((E, D))).astype(f)}


def run_moe(pkg, ins, capacity_factor):
    """(Out, AuxLoss, {slot: grad}) of one switch_moe op in ``pkg``."""
    fluid = jfluid if pkg == "jax" else tfluid
    L = fluid.layers
    main, startup = fluid.Program(), fluid.Program()
    N, D = ins["X"].shape
    cot = np.random.default_rng(99).standard_normal((N, D)).astype(
        np.float32)
    feed = dict(ins, cot=cot)
    with fluid.unique_name.guard(), fluid.program_guard(main, startup):
        block = main.global_block()
        leaves = {s: L.data(s, list(a.shape), "float32",
                            stop_gradient=False) for s, a in ins.items()}
        c = L.data("cot", [N, D], "float32")
        out = block.create_var(name="moe_out", shape=(N, D),
                               dtype="float32")
        aux = block.create_var(name="moe_aux", shape=(), dtype="float32")
        block.append_op(type="switch_moe",
                        inputs={s: [leaves[s]] for s in SLOTS},
                        outputs={"Out": [out], "AuxLoss": [aux]},
                        attrs={"capacity_factor": float(capacity_factor)},
                        infer_shape=False)
        loss = L.elementwise_add(L.reduce_sum(L.elementwise_mul(out, c)),
                                 L.scale(aux, AUX_W))
        grads = fluid.gradients([loss], [leaves[s] for s in SLOTS])
    exe = fluid.Executor() if pkg == "jax" else \
        fluid.Executor(fluid.CPUPlace())
    vals = [np.asarray(v) for v in exe.run(
        main, feed=feed, fetch_list=[out, aux] + grads)]
    return vals[0], vals[1], dict(zip(SLOTS, vals[2:]))


def pair(ins, capacity_factor):
    jo, ja, jg = run_moe("jax", ins, capacity_factor)
    to, ta, tg = run_moe("port", ins, capacity_factor)
    assert_close(to, jo, TOL, "Out")
    assert_close(ta, ja, TOL, "AuxLoss")
    for s in SLOTS:
        assert_close(tg[s], jg[s], TOL, f"{s}@GRAD")
    return to, ta, tg


@pytest.mark.parametrize("case", [
    dict(cf=1.25, seed=0),             # the layer's default: some drops
    dict(cf=2.0, seed=1),              # JAX test_moe_trains's factor
    dict(cf=0.5, seed=2),              # most experts overflow
    dict(cf=4.0, seed=3, E=8, H=8),    # no drops, more experts
])
def test_switch_moe_matches_jax_with_grads(case):
    ins = inputs(seed=case["seed"], E=case.get("E", 4),
                 H=case.get("H", 16))
    pair(ins, case["cf"])


def test_capacity_one_drops_overflow_like_jax():
    """C = 1 (capacity_factor E / N): at most E tokens survive, every
    other output row is 0, and the grads of the dropped rows' X come
    only through the gate."""
    N, E = 32, 4
    ins = inputs(N=N, E=E, seed=4)
    out, _, grads = pair(ins, E / N)
    zero_rows = int(np.sum(np.all(out == 0.0, axis=1)))
    assert zero_rows >= N - E, zero_rows


def test_tied_gates_route_to_the_first_expert_like_jax():
    """GateW = 0: every token's gates tie at 1/E, every token goes to
    expert 0 (the first index, as ``jnp.argmax``), the first C are kept,
    and the gate's cotangent is split among the tied maxima as
    ``jnp.max``'s. AuxLoss: density one-hot on expert 0, density_proxy
    1/E everywhere, so E * (1 * 1/E) = 1."""
    N, E = 32, 4
    ins = inputs(N=N, E=E, seed=5, gate_scale=0.0)
    out, aux, grads = pair(ins, 1.25)
    C = int(1.25 * N / E)
    kept = ~np.all(out == 0.0, axis=1)
    assert kept[:C].all() and not kept[C:].any(), kept
    np.testing.assert_allclose(float(aux), 1.0, rtol=1e-6)


def test_layer_shapes_and_dist_attr_as_in_jax():
    """``layers.switch_moe``: the same parameters (shapes, ``dist_attr``
    ``("ep",)`` on the experts, initializers) in both packages, and the
    same Out and AuxLoss from the same start."""
    N, D, E, H = 16, 8, 4, 16

    def build(fluid):
        x = fluid.layers.data("x", [N, D], dtype="float32")
        out, aux = fluid.layers.switch_moe(x, num_experts=E, d_hidden=H)
        return [out, aux]

    rng = np.random.default_rng(6)
    feed = {"x": rng.standard_normal((N, D)).astype(np.float32)}
    out, scopes, mains = run_pair(build, feed)
    for k in range(2):
        assert_close(out["port"][0][k], out["jax"][0][k], TOL, f"fetch {k}")
    jv = {p.name: p for p in mains["jax"].all_parameters()}
    tv = {p.name: p for p in mains["port"].all_parameters()}
    assert sorted(jv) == sorted(tv)
    for n, p in jv.items():
        assert tuple(tv[n].shape) == tuple(p.shape), n
        assert getattr(tv[n], "dist_attr", None) == \
            getattr(p, "dist_attr", None), n
    experts = [n for n, p in tv.items() if p.dist_attr == ("ep",)]
    assert len(experts) == 4
    assert {tuple(tv[n].shape) for n in experts} == {
        (E, D, H), (E, H), (E, H, D), (E, D)}
    # both startups draw the expert weights at the same scale
    ja = arrays(scopes["jax"])
    for n in experts:
        if len(tv[n].shape) == 3:
            want = (2.0 / (D + H)) ** 0.5
            got = float(scopes["port"].find_var(n).numpy().std())
            assert abs(got - want) < 0.3 * want, (n, got, want)
            assert abs(float(ja[n].std()) - want) < 0.3 * want
        else:
            assert not scopes["port"].find_var(n).numpy().any(), n


def _train(fluid, steps):
    """JAX ``tests/test_moe.py``'s ``_run(None, seed=5)``: the MoE block
    fit to tanh of the reversed input under Adam, from the JAX
    startup's values in both packages."""
    N, D, E, H = 32, 8, 4, 16
    rng = np.random.default_rng(0)
    xv = rng.standard_normal((N, D)).astype(np.float32)
    yv = np.tanh(xv[:, ::-1].copy()).astype(np.float32)

    def build(fl):
        x = fl.layers.data("x", [N, D], dtype="float32")
        y = fl.layers.data("y", [N, D], dtype="float32")
        out, aux = fl.layers.switch_moe(x, num_experts=E, d_hidden=H,
                                        capacity_factor=2.0)
        mse = fl.layers.mean(fl.layers.square_error_cost(out, y))
        loss = fl.layers.elementwise_add(mse, fl.layers.scale(aux, 0.01))
        fl.optimizer.Adam(0.01).minimize(loss)
        return [loss]

    return run_pair(build, {"x": xv, "y": yv}, steps)


def test_moe_trains_like_jax():
    """JAX ``test_moe_trains``: the loss halves in 30 Adam steps, and
    the port's losses follow JAX's step for step."""
    out, scopes, _ = _train(tfluid, 30)
    jl = [float(np.ravel(s[0])[0]) for s in out["jax"]]
    tl = [float(np.ravel(s[0])[0]) for s in out["port"]]
    assert tl[-1] < 0.5 * tl[0], tl[::10]
    np.testing.assert_allclose(tl, jl, rtol=2e-4)


def test_alltoall_is_the_identity_in_a_world_of_one():
    """``alltoall`` outside a launched world returns its input, as the
    JAX op does outside a mapped axis; its grad too."""
    from torch_pair import op_pair
    x = np.arange(24, dtype=np.float32).reshape(4, 6)
    out, grads = op_pair("alltoall", {"X": x}, {"ring_id": 0},
                         {"Out": ((4, 6), "float32")}, grad_slots=("X",))
    assert np.array_equal(out["Out"], x)


def test_device_guard_records_op_device_as_in_jax():
    """The top-level ``device_guard`` labels the ops made inside it with
    ``op_device``, in both packages; outside it nothing is set."""
    for fluid in (jfluid, tfluid):
        main, startup = fluid.Program(), fluid.Program()
        with fluid.program_guard(main, startup):
            x = fluid.layers.data("x", [2, 3], dtype="float32")
            with fluid.device_guard("gpu:1"):
                y = fluid.layers.scale(x, 2.0)
            z = fluid.layers.scale(y, 3.0)
        ops = main.global_block().ops
        assert ops[-2].attrs.get("op_device") == "gpu:1", fluid
        assert "op_device" not in ops[-1].attrs
        assert z is not None


def test_switch_gpt_trains_like_jax():
    """The slice as a whole at a tiny size: ``chip_smoke.moe_program``'s
    Switch GPT (a dense decoder layer, then one whose FFN is a
    ``switch_moe``; the LM loss + 0.01 x the mean aux loss; Adam) built
    in both packages from the JAX startup's values: 3 steps' losses
    within 1e-5 relative of JAX's."""
    import chip_smoke
    from paddle_tpu.models import gpt as jgpt
    from paddle_tpu_torch.models import gpt as tgpt
    run = dict(chip_smoke.MOE_PARITY, experts=4, d_hidden=64)
    B, S = 4, 16
    cfg = dict(vocab_size=128, hidden_size=32, num_layers=2, num_heads=2,
               ffn_size=64, max_position=64, dropout=0.0)
    losses, start = {}, None
    for pkg, fluid, gpt in (("jax", jfluid, jgpt), ("port", tfluid, tgpt)):
        c = gpt.GPTConfig(**cfg)
        main, startup, loss, moe_in = chip_smoke.moe_program(
            fluid, gpt, c, B, S, run)
        assert len(moe_in) == 1
        exe = fluid.Executor() if pkg == "jax" else \
            fluid.Executor(fluid.CPUPlace())
        scope = fluid.Scope()
        exe.run(startup, scope=scope)
        if pkg == "jax":
            start = arrays(scope)
        else:
            from paddle_tpu_torch.framework.executor import \
                scope_from_arrays
            scope_from_arrays(scope, start)
        feeds = [gpt.random_batch(c, B, S, rng=np.random.default_rng(i))
                 for i in range(3)]
        losses[pkg] = [float(np.ravel(exe.run(
            main, feed=f, fetch_list=[loss], scope=scope)[0])[0])
            for f in feeds]
    np.testing.assert_allclose(losses["port"], losses["jax"], rtol=1e-5)
