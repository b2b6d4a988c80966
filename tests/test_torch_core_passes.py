"""The port's program passes and verifier over the ops of the core layer
surface, against the JAX package's, on the CPU.

One program holds the v1 ops that loaded programs use (``reshape``,
``transpose``, ``squeeze``, ``unsqueeze``, ``flatten``, ``split``,
``feed``, ``fetch``), two identical pure ops (``cumsum``), two identical
random ops (``uniform_random``, ``randint``), a dead op and the matmul
and loss ops of the AMP lists (``matmul_v2``, ``bmm``, ``mse_loss``,
``huber_loss``). ``dce``, ``cse`` and ``fuse_optimizer`` give the same
program in both packages (``cse`` merges the pure pair and leaves the
random ones alone, ``dce`` drops the dead op and keeps ``feed`` and
``fetch``), ``amp_bf16`` puts the same casts around the same ops, and
the optimized program runs to the JAX program's fetches. The pytest run's
``FLAGS_verify_passes`` verifies every pass's output on both sides."""
import numpy as np

import paddle_tpu as jfluid
from paddle_tpu.contrib import mixed_precision as jmp
from paddle_tpu.framework import passes as jpasses

import paddle_tpu_torch as tfluid
from paddle_tpu_torch.contrib import mixed_precision as tmp
from paddle_tpu_torch.framework import passes as tpasses

from test_torch_amp import jax_dict
from torch_pair import assert_close

RNG = np.random.default_rng(8)
FEED = {"x": RNG.standard_normal((2, 3, 4)).astype(np.float32),
        "y": RNG.standard_normal((2, 4, 5)).astype(np.float32),
        "feed": np.zeros(1, np.float32)}


def _v1(block, op, x, out_shape, attrs, slot="Out", n=1):
    outs = [block.create_var(name=f"{op}_v1_{k}", shape=out_shape,
                             dtype="float32") for k in range(n)]
    block.append_op(type=op, inputs={"X": [x]}, outputs={slot: outs},
                    attrs=attrs)
    return outs if n > 1 else outs[0]


def build(fluid):
    L = fluid.layers
    main, startup = fluid.Program(), fluid.Program()
    with fluid.unique_name.guard(), fluid.program_guard(main, startup):
        block = main.global_block()
        x = L.data("x", [2, 3, 4], "float32")
        y = L.data("y", [2, 4, 5], "float32")
        holder = block.create_var(name="feed", shape=None, dtype="float32")
        block.append_op(type="feed", inputs={"X": [holder]},
                        outputs={"Out": [x]}, attrs={"col": 0},
                        infer_shape=False)
        r = _v1(block, "reshape", x, (6, 4), {"shape": [6, 4]})
        t = _v1(block, "transpose", r, (4, 6), {"axis": [1, 0]})
        u = _v1(block, "unsqueeze", t, (1, 4, 6), {"axes": [0]})
        s = _v1(block, "squeeze", u, (4, 6), {"axes": [0]})
        f = _v1(block, "flatten", x, (6, 4), {"axis": 2})
        a, b = _v1(block, "split", s, (4, 3), {"axis": 1, "num": 2,
                                              "sections": []}, n=2)
        c1, c2 = L.cumsum(f, axis=0), L.cumsum(f, axis=0)
        L.cumsum(a, axis=1)                               # dead
        u1 = L.uniform_random([2, 2], seed=0)
        u2 = L.uniform_random([2, 2], seed=0)
        k1 = block.create_var(name="ri_1", shape=(3,), dtype="int32")
        k2 = block.create_var(name="ri_2", shape=(3,), dtype="int32")
        for k in (k1, k2):
            block.append_op(type="randint", outputs={"Out": [k]},
                            attrs={"shape": [3], "low": 0, "high": 50,
                                   "dtype": "int32"})
        mm = L.matmul(x, y)
        mv = block.create_var(name="mv2", shape=(2, 3, 5), dtype="float32")
        block.append_op(type="matmul_v2", inputs={"X": [x], "Y": [y]},
                        outputs={"Out": [mv]}, attrs={})
        bm = L.bmm(x, y)
        loss = L.reduce_mean(L.mse_loss(mm, bm)) \
            + L.reduce_mean(L.huber_loss(mv, bm, 0.5))
        out = block.create_var(name="fetched", shape=(4, 3),
                               dtype="float32")
        block.append_op(type="fetch", inputs={"X": [b]},
                        outputs={"Out": [out]}, attrs={"col": 0},
                        infer_shape=False)
        fetch = [out, L.elementwise_add(c1, c2), u1, u2, k1, k2, loss]
    return main, [v.name for v in fetch]


def test_passes_match_jax_over_core_ops():
    (jmain, jfetch), (tmain, tfetch) = build(jfluid), build(tfluid)
    assert jfetch == tfetch
    jopt = jpasses.optimize_program(jmain, jfetch)
    topt = tpasses.optimize_program(tmain, tfetch)
    assert topt.to_dict() == jax_dict(jopt)
    types = [op.type for op in topt.global_block().ops]
    assert types.count("cumsum") == 1
    assert types.count("uniform_random") == 2
    assert types.count("randint") == 2
    assert "feed" in types and "fetch" in types
    assert [r["pass"] for r in tpasses.stats()["passes"]] == \
        [r["pass"] for r in jpasses.stats()["passes"]]


def test_amp_casts_match_jax_over_core_ops():
    progs = []
    for fluid, mp in ((jfluid, jmp), (tfluid, tmp)):
        main, _ = build(fluid)
        mp.rewrite_program(main, mp.AutoMixedPrecisionLists())
        progs.append(main)
    assert progs[1].to_dict() == jax_dict(progs[0])
    ops = progs[1].global_block().ops
    for t in ("matmul_v2", "bmm"):
        op = next(o for o in ops if o.type == t)
        assert progs[1].global_block().var(op.input("X")[0]).dtype == \
            "bfloat16"
    for t in ("mse_loss", "huber_loss"):
        op = next(o for o in ops if o.type == t)
        assert all(progs[1].global_block().var(n).dtype == "float32"
                   for n in op.input_arg_names)


def test_optimized_program_runs_as_jax():
    (jmain, jfetch), (tmain, tfetch) = build(jfluid), build(tfluid)
    jv = jfluid.Executor().run(jmain, feed=FEED, fetch_list=jfetch)
    tv = tfluid.Executor(tfluid.CPUPlace()).run(tmain, feed=FEED,
                                                fetch_list=tfetch)
    for i in (0, 1, 6):
        assert_close(tv[i], np.asarray(jv[i]), 1e-5, tfetch[i])
    for u in tv[2:4]:
        assert u.shape == (2, 2) and -1.0 <= u.min() and u.max() < 1.0
    # each random op draws from its own stream (its __rng_seed__)
    assert not np.array_equal(tv[2], tv[3])
    for k in tv[4:6]:
        assert k.shape == (3,) and k.min() >= 0 and k.max() < 50
