"""The program verifier in the port against the JAX package's.

The JAX package's verifier tests (``tests/test_program_verify.py``) that
the port's ops can express, each run on both packages over the same
program, and required to give the same diagnostic codes: one seeded
broken program per well-formedness check (unknown-op, missing-rng-seed,
dangling-read, use-before-def, duplicate-output, dead-persistable-write,
unreachable-fetch, shape-mismatch and dtype-mismatch), one deliberately
wrong pass per translation-validation invariant (side-effect-dropped,
rng-stream-dropped, persistable-write-dropped, dangling-read), the
executor's typed error and scope-aware verdict, and a clean default
pipeline over GPT tiny and BERT tiny (einsum and flash, bf16 AMP) with
``stats()``'s ``verify_ms``. The sub-block checks (``sub-block-scope``,
``reordered-past-observer``, the cyclic sub_block) need control-flow
ops, which the port does not have yet."""
import numpy as np
import pytest
import torch

import paddle_tpu as jfluid
from paddle_tpu.framework import analysis as janalysis
from paddle_tpu.framework import initializer as jinit
from paddle_tpu.framework import passes as jpasses

import paddle_tpu_torch as tfluid
from paddle_tpu_torch.framework import analysis as tanalysis
from paddle_tpu_torch.framework import initializer as tinit
from paddle_tpu_torch.framework import passes as tpasses


class Pkg:
    def __init__(self, fluid, analysis, passes, init, place):
        self.fluid, self.layers = fluid, fluid.layers
        self.analysis, self.passes, self.init = analysis, passes, init
        self.place = place

    def executor(self):
        return self.fluid.Executor(self.place)

    def verify_flag(self, on):
        return _flag(self.fluid, on)


JAX = Pkg(jfluid, janalysis, jpasses, jinit, None)
PORT = Pkg(tfluid, tanalysis, tpasses, tinit, tfluid.CPUPlace())
BOTH = (JAX, PORT)


class _flag:
    def __init__(self, fluid, on):
        self.fluid, self.on = fluid, on

    def __enter__(self):
        self.old = self.fluid.get_flags("FLAGS_verify_passes")
        self.fluid.set_flags({"FLAGS_verify_passes": self.on})

    def __exit__(self, *a):
        self.fluid.set_flags(self.old)


def _codes(diags):
    return [d.code for d in diags]


def _raised(pkg, fn):
    with pytest.raises(pkg.analysis.ProgramVerifyError) as ei:
        fn()
    return ei.value


def test_session_verifies_the_port():
    """tests/conftest.py sets FLAGS_verify_passes for the session; the
    port reads the same environment variable."""
    assert tfluid.get_flags("FLAGS_verify_passes") == \
        jfluid.get_flags("FLAGS_verify_passes") == \
        {"FLAGS_verify_passes": True}
    assert set(tanalysis.CHECKS) == set(janalysis.CHECKS)


# ---------------------------------- well-formedness checker mutations

def _simple_chain(pkg):
    L = pkg.layers
    main, startup = pkg.fluid.Program(), pkg.fluid.Program()
    with pkg.fluid.unique_name.guard(), \
            pkg.fluid.program_guard(main, startup):
        x = L.data("x", [4, 4], dtype="float32")
        a = L.scale(x, scale=2.0)
        b = L.scale(a, scale=3.0)
        out = L.reduce_sum(b)
    return main, startup, x, a, b, out


def _mutate_unknown_op(pkg, main, a, out):
    main.global_block().ops[1].type = "definitely_not_an_op"


def _mutate_dangling_read(pkg, main, a, out):
    main.global_block().ops[2].inputs["X"] = ["__ghost__"]


def _mutate_use_before_def(pkg, main, a, out):
    ops = main.global_block().ops
    ops[1], ops[2] = ops[2], ops[1]


def _mutate_duplicate_output(pkg, main, a, out):
    main.global_block().ops[1].outputs["Out"] = [a.name, a.name]


CHAIN_MUTANTS = {
    "unknown-op": (_mutate_unknown_op,
                   lambda e: e.op_index == 1
                   and "definitely_not_an_op" in str(e)),
    "dangling-read": (_mutate_dangling_read,
                      lambda e: e.var == "__ghost__"),
    "use-before-def": (_mutate_use_before_def, lambda e: True),
    "duplicate-output": (_mutate_duplicate_output,
                         lambda e: e.var.endswith(".tmp_0")),
}


@pytest.mark.parametrize("code", sorted(CHAIN_MUTANTS))
def test_checker_mutations_match_jax(code):
    mutate, check = CHAIN_MUTANTS[code]
    got = {}
    for pkg in BOTH:
        main, _, _, a, _, out = _simple_chain(pkg)
        assert pkg.analysis.collect_diagnostics(main, [out.name]) == []
        mutate(pkg, main, a, out)
        err = _raised(pkg, lambda: pkg.analysis.verify_program(
            main, fetch_names=[out.name]))
        assert check(err), err
        got[pkg is PORT] = (err.code, _codes(err.diagnostics), err.op_index,
                           err.op_type, err.var)
    assert got[True] == got[False]
    assert got[True][0] == code


def test_checker_missing_rng_seed_matches_jax():
    codes = []
    for pkg in BOTH:
        L = pkg.layers
        main, startup = pkg.fluid.Program(), pkg.fluid.Program()
        with pkg.fluid.unique_name.guard(), \
                pkg.fluid.program_guard(main, startup):
            x = L.data("x", [4, 4], dtype="float32")
            out = L.reduce_sum(L.dropout(x, dropout_prob=0.5))
        drop = next(op for op in main.global_block().ops
                    if op.type == "dropout")
        del drop.attrs["__rng_seed__"]
        err = _raised(pkg, lambda: pkg.analysis.verify_program(
            main, fetch_names=[out.name]))
        assert err.op_type == "dropout"
        codes.append(_codes(err.diagnostics))
    assert codes[0] == codes[1] == ["missing-rng-seed"]


def _snap_program(pkg, name, read_between):
    L = pkg.layers
    main, startup = pkg.fluid.Program(), pkg.fluid.Program()
    with pkg.fluid.unique_name.guard(), \
            pkg.fluid.program_guard(main, startup):
        x = L.data("x", [4, 4], dtype="float32")
        snap = L.create_global_var([1], 0.0, "float32", persistable=True,
                                   name=name)
        L.assign(L.reduce_sum(x), output=snap)
        y = L.scale(snap, scale=2.0) if read_between else None
        L.assign(L.scale(L.reduce_sum(x), scale=0.5), output=snap)
    return main, y


def test_checker_dead_persistable_write_matches_jax():
    for pkg in BOTH:
        main, _ = _snap_program(pkg, "dw_snap", False)
        diags = pkg.analysis.collect_diagnostics(
            main, fetch_names=["dw_snap"], pedantic=True)
        assert _codes(diags) == ["dead-persistable-write"]
        assert diags[0].var == "dw_snap" and diags[0].op_type == "assign"
        # the pedantic tier is opt-in: user programs legally double-init
        assert pkg.analysis.collect_diagnostics(
            main, fetch_names=["dw_snap"]) == []
        # a read between the writes makes the first write live
        main2, y = _snap_program(pkg, "dw_snap2", True)
        assert pkg.analysis.collect_diagnostics(
            main2, fetch_names=[y.name], pedantic=True) == []


def test_checker_unreachable_fetch_matches_jax():
    for pkg in BOTH:
        main, _, _, _, _, out = _simple_chain(pkg)
        err = _raised(pkg, lambda: pkg.analysis.verify_program(
            main, fetch_names=[out.name, "__no_such_var__"]))
        assert (err.code, err.var) == ("unreachable-fetch",
                                       "__no_such_var__")
        # scope state can supply it
        pkg.analysis.verify_program(
            main, fetch_names=[out.name, "__no_such_var__"],
            scope_names={"__no_such_var__"})


def test_checker_shape_and_dtype_mismatch_match_jax():
    got = []
    for pkg in BOTH:
        main, _, _, a, _, out = _simple_chain(pkg)
        collect = pkg.analysis.collect_diagnostics
        assert collect(main, [out.name], check_shapes=True) == []
        av = main.global_block().var(a.name)
        av.shape = (3, 7)
        shape = collect(main, [out.name], check_shapes=True)
        av.shape = (4, 4)
        av.dtype = "float64"
        dtype = collect(main, [out.name], check_shapes=True)
        assert (shape[0].code, shape[0].var) == ("shape-mismatch", a.name)
        assert (dtype[0].code, dtype[0].var) == ("dtype-mismatch", a.name)
        # op 0's findings and the codes agree; past op 0 a float64 input
        # stays float64 in torch, where the JAX package (x64 off) narrows
        # it to float32
        got.append(({(d.code, d.var) for d in shape + dtype
                     if d.op_index == 0},
                    {d.code for d in shape + dtype}))
    assert got[0] == got[1]


# ------------------------------- per-pass translation validation

def _run_mutant(pkg, name, cls, program, fetch_names):
    pkg.passes.register_pass(name)(cls)
    try:
        with pkg.verify_flag(True):
            err = _raised(pkg, lambda: pkg.passes.optimize_program(
                program, fetch_names=fetch_names, spec=name))
    finally:
        pkg.passes._PASSES.pop(name, None)
    assert err.pass_name == name, err
    return err


def _mutant_both(name, make_pass, build):
    """(code, op_type, var) of the error each package raises for the
    mutant pass ``make_pass(pkg)`` over ``build(pkg)``."""
    got = []
    for pkg in BOTH:
        program, fetches = build(pkg)
        err = _run_mutant(pkg, name, make_pass(pkg), program, fetches)
        got.append((err.code, err.op_type, err.var))
    assert got[0] == got[1], got
    return got[1]


def test_mutant_dce_drops_side_effect_op():
    """A ``print`` op (the JAX package's ``layers.Print``; unregistered in
    the port, whose verifier then also reports it as an unknown op of the
    input, which a pass is never blamed for)."""
    def make(pkg):
        class BadDce(pkg.passes.Pass):
            def apply(self, program):
                blk = program.global_block()
                blk.ops = [op for op in blk.ops if op.type != "print"]
        return BadDce

    def build(pkg):
        L = pkg.layers
        main, startup = pkg.fluid.Program(), pkg.fluid.Program()
        with pkg.fluid.unique_name.guard(), \
                pkg.fluid.program_guard(main, startup):
            x = L.data("x", [-1, 4], dtype="float32")
            out = L.reduce_sum(L.scale(x, scale=2.0))
            main.global_block().append_op(
                type="print", inputs={"In": [out]},
                outputs={"Out": [out]},
                attrs={"message": "must-survive"}, infer_shape=False)
        return main, [out.name]
    assert _mutant_both("_mut_dce_print", make, build) == \
        ("side-effect-dropped", "print", None)


def test_mutant_cse_merges_rng_ops():
    def make(pkg):
        class BadCse(pkg.passes.Pass):
            def apply(self, program):
                blk = program.global_block()
                drops = [op for op in blk.ops if op.type == "dropout"]
                keep, merge = drops[0], drops[1]
                rename = dict(zip(merge.output_arg_names,
                                  keep.output_arg_names))
                blk.ops.remove(merge)
                for op in blk.ops:
                    for slot, names in op.inputs.items():
                        op.inputs[slot] = [rename.get(n, n) for n in names]
        return BadCse

    def build(pkg):
        L = pkg.layers
        main, startup = pkg.fluid.Program(), pkg.fluid.Program()
        with pkg.fluid.unique_name.guard(), \
                pkg.fluid.program_guard(main, startup):
            x = L.data("x", [-1, 4], dtype="float32")
            d1 = L.dropout(x, dropout_prob=0.5)
            d2 = L.dropout(x, dropout_prob=0.5)
            out = L.reduce_sum(d1 + d2)
        return main, [out.name]
    assert _mutant_both("_mut_cse_rng", make, build) == \
        ("rng-stream-dropped", "dropout", None)


def _adam_program(pkg, with_dropout=False):
    """fc -> tanh -> (dropout) -> fc -> mean loss, Adam (the port's fc
    takes an explicit initializer)."""
    L = pkg.layers

    def attr():
        return pkg.fluid.ParamAttr(initializer=pkg.init.Normal(0.0, 0.1))
    main, startup = pkg.fluid.Program(), pkg.fluid.Program()
    with pkg.fluid.unique_name.guard(), \
            pkg.fluid.program_guard(main, startup):
        x = L.data("x", [-1, 4], dtype="float32")
        h = L.fc(x, 16, act="tanh", param_attr=attr())
        if with_dropout:
            h = L.dropout(h, dropout_prob=0.3)
        loss = L.mean(L.fc(h, 1, param_attr=attr()))
        pkg.fluid.optimizer.AdamOptimizer(0.01).minimize(loss)
    return main, startup, loss


def test_mutant_drops_optimizer_update():
    def make(pkg):
        class BadFuse(pkg.passes.Pass):
            def apply(self, program):
                blk = program.global_block()
                del blk.ops[next(i for i, op in enumerate(blk.ops)
                                 if op.type == "adam")]
        return BadFuse

    def build(pkg):
        main, _, loss = _adam_program(pkg)
        return main, [loss.name]
    code, _, var = _mutant_both("_mut_drop_adam", make, build)
    assert code == "persistable-write-dropped" and var


def test_mutant_drops_one_of_two_persistable_writes():
    def make(pkg):
        class BadDropOne(pkg.passes.Pass):
            def apply(self, program):
                blk = program.global_block()
                del blk.ops[next(i for i, op in enumerate(blk.ops)
                                 if op.type == "assign"
                                 and "dw2_snap" in op.output_arg_names)]
        return BadDropOne

    def build(pkg):
        main, y = _snap_program(pkg, "dw2_snap", True)
        return main, [y.name]
    assert _mutant_both("_mut_drop_one", make, build) == \
        ("persistable-write-dropped", None, "dw2_snap")


def test_mutant_introduces_dangling_read():
    def make(pkg):
        class BadRename(pkg.passes.Pass):
            def apply(self, program):
                op = program.global_block().ops[-1]
                op.inputs[list(op.inputs)[0]] = ["__invented_by_pass__"]
        return BadRename

    def build(pkg):
        main, _, _, _, _, out = _simple_chain(pkg)
        return main, [out.name]
    assert _mutant_both("_mut_dangle", make, build) == \
        ("dangling-read", "reduce_sum", "__invented_by_pass__")


def test_preexisting_findings_not_blamed_on_passes():
    for pkg in BOTH:
        main, _, _, _, _, out = _simple_chain(pkg)
        main.global_block().ops[1].inputs.setdefault(
            "__extra__", ["__preexisting_ghost__"])
        with pkg.verify_flag(True):
            opt = pkg.passes.optimize_program(main, fetch_names=[out.name])
        assert opt is not main


def test_correct_pipeline_validates_clean_with_stats():
    types = []
    for pkg in BOTH:
        main, _, loss = _adam_program(pkg, with_dropout=True)
        with pkg.verify_flag(True):
            opt = pkg.passes.optimize_program(main, fetch_names=[loss.name])
        st = pkg.passes.stats()
        assert st["verify_ms"] > 0
        assert all("verify_ms" in row for row in st["passes"])
        assert pkg.analysis.collect_diagnostics(
            opt, fetch_names=[loss.name]) == []
        types.append([op.type for op in opt.global_block().ops])
        with pkg.verify_flag(False):
            pkg.passes.optimize_program(main, fetch_names=[loss.name])
        assert pkg.passes.stats()["verify_ms"] == 0.0
    assert types[0] == types[1]


# ------------------------------------------------ executor wiring

def _ghost_program(pkg, name, shape):
    L = pkg.layers
    main, startup = pkg.fluid.Program(), pkg.fluid.Program()
    with pkg.fluid.unique_name.guard(), \
            pkg.fluid.program_guard(main, startup):
        x = L.data("x", shape, dtype="float32")
        ghost = main.global_block().create_var(name=name, shape=shape,
                                               dtype="float32")
        y = L.elementwise_add(x, ghost)
    return main, startup, y


def test_executor_raises_typed_error_not_keyerror():
    for pkg in BOTH:
        main, startup, y = _ghost_program(pkg, "vr_ghost", [4, 4])
        exe = pkg.executor()
        with pkg.verify_flag(True), \
                pkg.fluid.scope_guard(pkg.fluid.Scope()):
            exe.run(startup)
            err = _raised(pkg, lambda: exe.run(
                main, feed={"x": np.ones((4, 4), np.float32)},
                fetch_list=[y]))
        assert (err.code, err.var) == ("dangling-read", "vr_ghost")
    assert exe.verify_ms > 0


def test_executor_verify_not_stale_across_scopes():
    """A clean verdict under one scope is not served to a later run whose
    scope lacks the state var."""
    for pkg in BOTH:
        main, startup, y = _ghost_program(pkg, "vr_state2", [-1, 4])
        exe = pkg.executor()
        good = pkg.fluid.Scope()
        with pkg.verify_flag(True):
            with pkg.fluid.scope_guard(good):
                exe.run(startup)
                good.set("vr_state2", np.ones((2, 4), np.float32)
                         if pkg is JAX else torch.ones(2, 4))
                exe.run(main, feed={"x": np.ones((2, 4), np.float32)},
                        fetch_list=[y])
            with pkg.fluid.scope_guard(pkg.fluid.Scope()):
                exe.run(startup)
                err = _raised(pkg, lambda: exe.run(
                    main, feed={"x": np.ones((3, 4), np.float32)},
                    fetch_list=[y]))
        assert (err.code, err.var) == ("dangling-read", "vr_state2")


def test_executor_scope_supplies_state_reads():
    for pkg in BOTH:
        main, startup, y = _ghost_program(pkg, "vr_state", [4, 4])
        exe = pkg.executor()
        scope = pkg.fluid.Scope()
        with pkg.verify_flag(True), pkg.fluid.scope_guard(scope):
            exe.run(startup)
            scope.set("vr_state", np.full((4, 4), 2.0, np.float32)
                      if pkg is JAX else torch.full((4, 4), 2.0))
            out, = exe.run(main, feed={"x": np.ones((4, 4), np.float32)},
                           fetch_list=[y])
        np.testing.assert_allclose(np.asarray(out), 3.0)


def test_empty_and_all_dead_programs_with_persistable_fetch():
    for pkg in BOTH:
        L = pkg.layers
        main, startup = pkg.fluid.Program(), pkg.fluid.Program()
        with pkg.fluid.unique_name.guard(), \
                pkg.fluid.program_guard(main, startup):
            x = L.data("x", [4, 4], dtype="float32")
            L.scale(x, scale=2.0)                     # dead
            L.create_global_var([1], 3.0, "float32", persistable=True,
                                name="deg_live")
        with pkg.verify_flag(True):
            opt = pkg.passes.optimize_program(main, fetch_names=["deg_live"])
            assert opt.global_block().ops == []
            pkg.analysis.verify_program(opt, fetch_names=["deg_live"])
            exe = pkg.executor()
            with pkg.fluid.scope_guard(pkg.fluid.Scope()):
                exe.run(startup)
                out, = exe.run(main,
                               feed={"x": np.ones((4, 4), np.float32)},
                               fetch_list=["deg_live"])
        assert float(np.asarray(out).reshape(())) == 3.0


# -------------------------------------------------- verifier-clean zoo

def _gpt_tiny(pkg):
    from paddle_tpu.models import gpt as jgpt
    from paddle_tpu_torch.models import gpt as tgpt
    gpt = jgpt if pkg is JAX else tgpt
    main, startup = pkg.fluid.Program(), pkg.fluid.Program()
    with pkg.fluid.unique_name.guard(), \
            pkg.fluid.program_guard(main, startup):
        out = gpt.gpt_pretrain(gpt.GPTConfig.tiny(), 4, 16)
        pkg.fluid.optimizer.AdamOptimizer(1e-3).minimize(out["loss"])
    return main, startup, out["loss"].name


def _bert_tiny(pkg, mech, amp):
    from test_torch_bert import JAX as JB, PORT as TB, build
    _, main, startup, names = build(JB if pkg is JAX else TB, mech, amp,
                                    dropout=0.1)
    return main, startup, names["loss"]


ZOO = {"gpt": _gpt_tiny,
       "bert": lambda pkg: _bert_tiny(pkg, None, False),
       "bert_flash_amp": lambda pkg: _bert_tiny(pkg, "flash", True)}


@pytest.mark.parametrize("name", sorted(ZOO))
def test_zoo_programs_verify_clean_and_run(name):
    """Clean before and after the default pipeline in both packages, the
    same optimized program, and one port step through the verifying
    executor (``verify_ms`` > 0)."""
    dicts = []
    for pkg in BOTH:
        main, startup, loss = ZOO[name](pkg)
        for prog, fetches in ((main, [loss]), (startup, [])):
            assert pkg.analysis.collect_diagnostics(prog, fetches) == []
        with pkg.verify_flag(True):
            opt = pkg.passes.optimize_program(main, fetch_names=[loss])
        assert pkg.passes.stats()["verify_ms"] > 0
        assert pkg.analysis.collect_diagnostics(opt, [loss]) == []
        dicts.append([op.type for op in opt.global_block().ops])
    assert dicts[0] == dicts[1]
    exe = PORT.executor()
    scope = tfluid.Scope()
    with PORT.verify_flag(True):
        exe.run(startup, scope=scope)
        feed = _zoo_feed(name)
        lv, = exe.run(main, feed=feed, fetch_list=[loss], scope=scope)
    assert np.isfinite(lv).all() and exe.verify_ms > 0


def _zoo_feed(name):
    rng = np.random.default_rng(0)
    if name == "gpt":
        from paddle_tpu_torch.models import gpt as tgpt
        return tgpt.random_batch(tgpt.GPTConfig.tiny(), 4, 16, rng=rng)
    from paddle_tpu_torch.models import bert as tbert
    from test_torch_bert import B, P, S
    return tbert.random_batch(tbert.BertConfig.tiny(), B, S, P, rng=rng)
