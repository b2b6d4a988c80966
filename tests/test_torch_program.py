"""The port's Program IR against the JAX package's: the same builder calls
(``gpt_pretrain`` + ``AdamOptimizer.minimize`` at GPTConfig.tiny()) give
the same ``program.to_dict()``, op for op, for the main and the startup
program, and ``clone(for_test=True)`` prunes both alike.

Each var's ``dist_attr`` key is compared too: None for every var of
these programs in both packages."""
import numpy as np
import pytest

import paddle_tpu as jfluid
from paddle_tpu.framework import unique_name as j_unique_name
from paddle_tpu.models import gpt as jgpt

import paddle_tpu_torch as tfluid
from paddle_tpu_torch.models import gpt as tgpt


def _build(fluid, gpt, unique_name, batch=4, seq=16, lr=1e-3):
    cfg = gpt.GPTConfig.tiny()
    main, startup = fluid.Program(), fluid.Program()
    with unique_name.guard():
        with fluid.program_guard(main, startup):
            out = gpt.gpt_pretrain(cfg, batch, seq)
            fluid.optimizer.AdamOptimizer(lr).minimize(out["loss"])
    return main, startup, out


def _jax_dict(program):
    d = program.to_dict()
    for blk in d["blocks"]:
        for v in blk["vars"].values():
            assert v["dist_attr"] is None
    return d


@pytest.fixture(scope="module")
def programs():
    return (_build(jfluid, jgpt, j_unique_name),
            _build(tfluid, tgpt, tfluid.unique_name))


@pytest.mark.parametrize("which", ["main", "startup"])
def test_gpt_train_program_to_dict_equals_jax(programs, which):
    (jmain, jstart, _), (tmain, tstart, _) = programs
    j, t = (jmain, tmain) if which == "main" else (jstart, tstart)
    jd, td = _jax_dict(j), t.to_dict()
    assert [op["type"] for op in td["blocks"][0]["ops"]] == \
        [op["type"] for op in jd["blocks"][0]["ops"]]
    assert td["blocks"][0]["vars"] == jd["blocks"][0]["vars"]
    for i, (top, jop) in enumerate(zip(td["blocks"][0]["ops"],
                                       jd["blocks"][0]["ops"])):
        assert top == jop, (i, top["type"])
    assert td == jd


def test_gpt_train_program_shape(programs):
    """104 main ops: forward, grads, 16 ``adam``, and ``sum`` ops where a
    var has two readers (the residual stream, and the tied embedding:
    ``lookup_table_grad`` + ``matmul_grad``); 81 startup ops."""
    _, (tmain, tstart, _) = programs
    ops = tmain.global_block().ops
    types = [op.type for op in ops]
    assert len(types) == 104 and types.count("adam") == 16
    sums = [op for op in ops if op.type == "sum"]
    assert len(sums) == 4
    assert ["word_embedding@GRAD"] in [op.output("Out") for op in sums]
    st = [op.type for op in tstart.global_block().ops]
    assert (len(st), st.count("gaussian_random")) == (81, 6)


def test_clone_for_test_equals_jax(programs):
    (jmain, _, _), (tmain, _, _) = programs
    jc, tc = jmain.clone(for_test=True), tmain.clone(for_test=True)
    assert tc.to_dict() == _jax_dict(jc)
    assert all(op.attrs.get("op_role", 0) == 0
               for op in tc.global_block().ops)


def test_from_dict_round_trip(programs):
    _, (tmain, tstart, _) = programs
    for p in (tmain, tstart):
        assert tfluid.Program.from_dict(p.to_dict()).to_dict() == \
            p.to_dict()


def test_seeded_ops_share_the_jax_seed_counter(programs):
    """Stochastic ops (dropout, gaussian_random) get the same per-program
    ``__rng_seed__`` numbers as the JAX build; grad ops get none of their
    own and read the forward's through ``__fwd_op__``."""
    (jmain, jstart, _), (tmain, tstart, _) = programs
    for j, t in ((jmain, tmain), (jstart, tstart)):
        seeds = [op.attrs.get("__rng_seed__") for op in
                 t.global_block().ops]
        assert seeds == [op.attrs.get("__rng_seed__") for op in
                         j.global_block().ops]
    grads = [op for op in tmain.global_block().ops
             if op.type == "dropout_grad"]
    assert grads and all("__rng_seed__" not in op.attrs
                         and op.attrs["__fwd_op__"]["attrs"]["__rng_seed__"]
                         for op in grads)
    assert np.all(np.diff([op.attrs["__rng_seed__"] for op in
                           tstart.global_block().ops
                           if "__rng_seed__" in op.attrs]) > 0)
