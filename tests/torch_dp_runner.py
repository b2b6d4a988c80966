"""Worker of the port's data-parallel CPU tests
(``test_torch_parallel.py``, ``test_torch_fleet.py``,
``test_torch_dygraph_parallel.py``): one rank of a gloo world started by
``python -m paddle_tpu_torch.distributed.launch --nproc_per_node=4
--device=cpu``.

    python torch_dp_runner.py <args.json>

``args``: ``{"out": dir, "scenarios": [names], "start": {model: npz
path}}``. Each scenario writes ``<out>/<scenario>.<rank>.npz`` (its
arrays; ``__flags__`` holds a JSON of its booleans and numbers). The
model builders take either package's ``fluid``, so a test builds the JAX
reference program from the same function; the JAX package's startup
values reach the ranks through the ``start`` files
(``scope_from_arrays``). Every rank is fed rows ``[r b, (r + 1) b)`` of
one global batch made here from a seed. This module imports the port
only (the ranks never import JAX).
"""
import json
import os
import sys

import numpy as np

B_GLOBAL = 8
STEPS = 3


# ----------------------------------------------------------------- models

def bn_classifier(fluid, lr=0.1):
    """fc + batch_norm + relu + fc, softmax cross-entropy, Momentum. The
    fc before the batch norm has no bias (the norm takes any per-channel
    constant out, so its grad would be rounding noise)."""
    layers = fluid.layers
    x = fluid.data("x", [-1, 16], "float32")
    y = fluid.data("y", [-1, 1], "int64")
    h = layers.fc(x, 32, bias_attr=False)
    h = layers.batch_norm(h, act="relu")
    logits = layers.fc(h, 4)
    loss = layers.mean(layers.softmax_with_cross_entropy(logits, y))
    fluid.optimizer.Momentum(lr, 0.9).minimize(loss)
    return loss


def narrow_resnet(fluid, lr=0.05):
    """A ResNet of two basic blocks at widths 8 and 16 (batch norm after
    every conv, a strided projection shortcut), 8x8 images, Momentum."""
    layers = fluid.layers
    x = fluid.data("image", [-1, 3, 8, 8], "float32")
    y = fluid.data("label", [-1, 1], "int64")

    def conv_bn(h, ch, k, stride=1, act="relu"):
        h = layers.conv2d(h, ch, k, stride=stride, padding=(k - 1) // 2,
                          bias_attr=False)
        return layers.batch_norm(h, act=act)

    h = conv_bn(x, 8, 3)
    for ch, stride in ((8, 1), (16, 2)):
        short = h if stride == 1 else conv_bn(h, ch, 1, stride, act=None)
        out = conv_bn(conv_bn(h, ch, 3, stride), ch, 3, act=None)
        h = layers.relu(layers.elementwise_add(out, short))
    h = layers.pool2d(h, pool_type="avg", global_pooling=True)
    logits = layers.fc(h, 4)
    loss = layers.mean(layers.softmax_with_cross_entropy(logits, y))
    fluid.optimizer.Momentum(lr, 0.9).minimize(loss)
    return loss


def fleet_mlp(fluid):
    """``tests/dist_fleet_runner.py``'s model: fc(16, tanh) + fc(1), no
    biases, square error; the optimizer is the caller's."""
    layers = fluid.layers
    x = fluid.data("x", [-1, 8], "float32")
    y = fluid.data("y", [-1, 1], "float32")
    h = layers.fc(x, 16, act="tanh", param_attr=fluid.ParamAttr(name="w1"),
                  bias_attr=False)
    pred = layers.fc(h, 1, param_attr=fluid.ParamAttr(name="w2"),
                     bias_attr=False)
    return layers.mean(layers.square_error_cost(pred, y))


def bert_tiny_cfg(bert):
    cfg = bert.BertConfig.tiny()
    cfg.hidden_dropout = cfg.attn_dropout = 0.0
    return cfg


BERT_SHAPE = {"B": 8, "S": 16, "P": 3}


def bert_tiny(fluid, bert):
    s = BERT_SHAPE
    out = bert.bert_pretrain(bert_tiny_cfg(bert), s["B"] // 4, s["S"],
                             s["P"])
    return out


# Wide&Deep at tests/test_models.py::test_widedeep_sharded_tables's shape
WD = {"dense_dim": 4, "num_slots": 4, "vocab_size": 64, "embed_dim": 8,
      "hidden_sizes": (16,)}
WD_B = 16
# (name, mesh axes, lazy Adam, table_dist_attr, feeds, how the steps
# run: "run" one exe.run each, "steps" one exe.run_steps of all, captured
# behind the multi-slice gate); "oob": after a first step over the whole
# vocabulary, every id of steps 2 and 3 lies in the first half, so the
# second mp shard sees only ids outside it; "dcn2dp2": two slices of two,
# the sparse grads all-gathered over the joint data axis (hier_grad_sync
# leaves them to dp_grad_allreduce)
WD_CASES = (("dp4", {"dp": 4}, False, None, "full", "run"),
            ("dp4_lazy", {"dp": 4}, True, None, "full", "run"),
            ("dp2mp2", {"dp": 2, "tp": 2}, False, ("mp", None), "full", "run"),
            ("dp2mp2_lazy", {"dp": 2, "tp": 2}, True, ("mp", None), "full",
             "run"),
            ("oob_lazy", {"dp": 2, "tp": 2}, True, ("mp", None), "oob", "run"),
            ("dcn2dp2", {"dcn_dp": 2, "dp": 2}, False, None, "full", "run"),
            ("dcn2dp2_steps", {"dcn_dp": 2, "dp": 2}, False, None, "full",
             "steps"))


def wide_deep(fluid, wd, lazy=False, dist=None):
    """``wide_deep`` at ``WD`` (tables sharded by ``dist``), Adam at 1e-2
    (lazy or not)."""
    out = wd.wide_deep(table_dist_attr=dist, **WD)
    fluid.optimizer.AdamOptimizer(1e-2, lazy_mode=lazy).minimize(
        out["loss"])
    return out["loss"]


def wd_feeds(wd, kind="full", steps=STEPS, seed=30):
    out = []
    for i in range(steps):
        f = wd.random_batch(WD_B, WD["dense_dim"], WD["num_slots"],
                            WD["vocab_size"],
                            rng=np.random.default_rng(seed + i))
        if kind == "oob" and i:
            for j in range(WD["num_slots"]):
                f[f"C{j}"] = f[f"C{j}"] % (WD["vocab_size"] // 2)
            f["label"] = (f["C0"] % 2).astype(np.int64)
        out.append(f)
    return out


# ----------------------------------------------------------------- feeds

def classifier_feeds(steps=STEPS, seed=0):
    rng = np.random.default_rng(seed)
    return [{"x": rng.standard_normal((B_GLOBAL, 16)).astype("float32"),
             "y": rng.integers(0, 4, (B_GLOBAL, 1)).astype("int64")}
            for _ in range(steps)]


def image_feeds(steps=STEPS, seed=1):
    rng = np.random.default_rng(seed)
    return [{"image": rng.standard_normal((B_GLOBAL, 3, 8, 8))
             .astype("float32"),
             "label": rng.integers(0, 4, (B_GLOBAL, 1)).astype("int64")}
            for _ in range(steps)]


def fleet_feeds(steps=4):
    """``dist_fleet_runner.py``'s global batches."""
    out = []
    for step in range(steps):
        brng = np.random.default_rng(500 + step)
        xg = brng.standard_normal((B_GLOBAL, 8)).astype(np.float32)
        out.append({"x": xg, "y": (xg[:, :1] * 0.7 - 0.2)
                    .astype(np.float32)})
    return out


def bert_feeds(bert, steps=2):
    s = BERT_SHAPE
    cfg = bert_tiny_cfg(bert)
    return [bert.random_batch(cfg, s["B"], s["S"], s["P"],
                              rng=np.random.default_rng(40 + i))
            for i in range(steps)]


def rows(feed, rank, n):
    """Rank ``rank``'s rows of a global feed (every array split on dim
    0)."""
    out = {}
    for k, v in feed.items():
        b = v.shape[0] // n
        out[k] = v[rank * b:(rank + 1) * b]
    return out


def bert_rows(feed, rank, n):
    """Rank ``rank``'s sequences of a BERT batch: ``mask_pos`` indexes
    the flattened [B*S] tokens, so it is re-based on the rank's first
    sequence."""
    s = BERT_SHAPE
    b = s["B"] // n
    out = {k: feed[k][rank * b:(rank + 1) * b]
           for k in ("src_ids", "sent_ids", "pos_ids", "input_mask",
                     "labels")}
    pos = feed["mask_pos"].reshape(s["B"], s["P"])[rank * b:(rank + 1) * b]
    out["mask_pos"] = (pos - rank * b * s["S"]).reshape(-1)
    out["mask_label"] = feed["mask_label"][rank * b * s["P"]:
                                           (rank + 1) * b * s["P"]]
    return out


# ------------------------------------------------------------- scenarios

class Ctx:
    def __init__(self, args):
        import torch
        torch.set_num_threads(1)
        import paddle_tpu_torch as fluid
        from paddle_tpu_torch.parallel import mesh
        self.fluid = fluid
        self.args = args
        mesh.init_parallel_env()
        self.rank, self.n = mesh.rank(), mesh.world_size()
        self.place = fluid.CPUPlace()

    def start(self, model):
        path = self.args["start"][model]
        with np.load(path) as z:
            return {k: z[k] for k in z.files}

    def build(self, fn, *a, seed=7):
        fluid = self.fluid
        main, startup = fluid.Program(), fluid.Program()
        main.random_seed = startup.random_seed = seed
        with fluid.unique_name.guard(), fluid.program_guard(main, startup):
            loss = fn(fluid, *a)
        return main, startup, loss

    def scope(self, startup, model):
        from paddle_tpu_torch.framework.executor import scope_from_arrays
        exe = self.fluid.Executor(self.place)
        scope = self.fluid.Scope()
        exe.run(startup, scope=scope)
        scope_from_arrays(scope, self.start(model))
        return exe, scope


def params(fluid, main, scope):
    return {p.name: scope.find_var(p.name).numpy().copy()
            for p in main.all_parameters()}


def state(scope):
    import torch
    return {k: v.numpy().copy() for k, v in scope.items()
            if isinstance(v, torch.Tensor)}


def _same(a, b):
    return set(a) == set(b) and all(np.array_equal(a[k], b[k]) for k in a)


def sc_bn(c):
    """The batch_norm classifier, 3 steps, without and with
    BuildStrategy.sync_batch_norm."""
    out, flags = {}, {}
    for sync in (False, True):
        main, startup, loss = c.build(bn_classifier)
        exe, scope = c.scope(startup, "bn")
        bs = c.fluid.BuildStrategy()
        bs.sync_batch_norm = sync
        comp = c.fluid.CompiledProgram(main, build_strategy=bs) \
            .with_data_parallel(loss_name=loss.name)
        types = [op.type for op in comp.program.global_block().ops]
        flags[f"sync_bn_ops_{sync}"] = types.count("sync_batch_norm")
        flags[f"allreduce_ops_{sync}"] = types.count(
            "c_coalesced_allreduce_sum")
        losses = [float(exe.run(comp, feed=rows(f, c.rank, c.n),
                                fetch_list=[loss], scope=scope)[0])
                  for f in classifier_feeds()]
        out[f"losses_{sync}"] = np.array(losses)
        for k, v in state(scope).items():
            out[f"{sync}/{k}"] = v
    return out, flags


def sc_resnet(c):
    main, startup, loss = c.build(narrow_resnet)
    exe, scope = c.scope(startup, "resnet")
    comp = c.fluid.CompiledProgram(main).with_data_parallel(
        loss_name=loss.name)
    losses = [float(exe.run(comp, feed=rows(f, c.rank, c.n),
                            fetch_list=[loss], scope=scope)[0])
              for f in image_feeds()]
    out = {"losses": np.array(losses)}
    out.update(state(scope))
    return out, {}


def sc_run_steps(c):
    """run_steps through a CompiledProgram against its eager steps, from
    one start: fetches and every state tensor bitwise."""
    main, startup, loss = c.build(bn_classifier)
    exe, s1 = c.scope(startup, "bn")
    _, s2 = c.scope(startup, "bn")
    comp = c.fluid.CompiledProgram(main).with_data_parallel(
        loss_name=loss.name)
    feeds = [rows(f, c.rank, c.n) for f in classifier_feeds()]
    seq = [exe.run(comp, feed=f, fetch_list=[loss], scope=s1)[0]
           for f in feeds]
    fused, = exe.run_steps(comp, feed=feeds, fetch_list=[loss], scope=s2)
    same_fetch = bool(np.array_equal(np.stack(seq).reshape(-1),
                                     np.asarray(fused).reshape(-1)))
    out = {"losses": np.asarray(fused).reshape(-1)}
    out.update(state(s2))
    return out, {"fetch_bitwise": same_fetch,
                 "scope_bitwise": _same(state(s1), state(s2))}


def sc_parallel_executor(c):
    main, startup, loss = c.build(bn_classifier)
    exe, scope = c.scope(startup, "bn")
    pe = c.fluid.ParallelExecutor(use_cuda=False, loss_name=loss.name,
                                  main_program=main, scope=scope)
    losses = [float(pe.run([loss], feed=rows(f, c.rank, c.n))[0])
              for f in classifier_feeds()]
    out = {"losses": np.array(losses)}
    out.update(state(scope))
    return out, {}


def collective_program(fluid, n):
    """Each collective op on a fed ``x`` (rank-dependent data) in a world
    of ``n``, and the grad of sum(c_allreduce_sum(x) * cot) +
    sum(c_allgather(x) * cot2) with respect to x."""
    layers = fluid.layers
    x = fluid.data("x", [4, 3], "float32")
    x.stop_gradient = False
    cot = fluid.data("cot", [4, 3], "float32")
    cot2 = fluid.data("cot2", [4 * n, 3], "float32")
    outs = {}
    block = fluid.default_main_program().global_block()
    for op, extra in (("c_allreduce_sum", {}), ("c_allreduce_max", {}),
                      ("c_allreduce_min", {}), ("c_allreduce_prod", {}),
                      ("allreduce", {}), ("c_allgather", {"nranks": n}),
                      ("c_reducescatter", {}), ("c_broadcast", {"root": 2}),
                      ("broadcast", {"root": 1}),
                      ("c_sync_calc_stream", {}),
                      ("c_sync_comm_stream", {})):
        out = block.create_var(name=f"out_{op}", dtype="float32")
        block.append_op(type=op, inputs={"X": [x]}, outputs={"Out": [out]},
                        attrs=dict(extra, ring_id=0), infer_shape=False)
        outs[op] = out
    s1 = layers.reduce_sum(layers.elementwise_mul(outs["c_allreduce_sum"],
                                                  cot))
    s2 = layers.reduce_sum(layers.elementwise_mul(outs["c_allgather"], cot2))
    g, = fluid.gradients([layers.elementwise_add(s1, s2)], [x])
    return outs, g


def collective_feed(rank, n):
    rng = np.random.default_rng(100 + rank)
    return {"x": (rng.uniform(0.5, 1.5, (4, 3))).astype("float32"),
            "cot": rng.standard_normal((4, 3)).astype("float32"),
            "cot2": np.random.default_rng(99).standard_normal(
                (4 * n, 3)).astype("float32")}


def sc_collectives(c):
    fluid = c.fluid
    main, startup = fluid.Program(), fluid.Program()
    with fluid.unique_name.guard(), fluid.program_guard(main, startup):
        outs, g = collective_program(fluid, c.n)
    exe = fluid.Executor(c.place)
    names = sorted(outs)
    vals = exe.run(main, feed=collective_feed(c.rank, c.n),
                   fetch_list=[outs[n] for n in names] + [g])
    out = dict(zip(names, vals))
    out["grad"] = vals[-1]
    return out, {}


def sc_ckpt(c):
    """save_persistables after 2 of 4 steps (rank 0 writes, every rank
    waits), a fresh scope that loads it and 2 more steps, against the
    uninterrupted 4 steps; then a TrainCheckpoint round trip."""
    import torch
    from paddle_tpu_torch import io, train
    fluid = c.fluid
    main, startup, loss = c.build(bn_classifier)
    comp = fluid.CompiledProgram(main).with_data_parallel(
        loss_name=loss.name)
    feeds = [rows(f, c.rank, c.n) for f in classifier_feeds(4, seed=3)]
    exe, sa = c.scope(startup, "bn")
    base = [exe.run(comp, feed=f, fetch_list=[loss], scope=sa)[0]
            for f in feeds]
    _, sb = c.scope(startup, "bn")
    for f in feeds[:2]:
        exe.run(comp, feed=f, fetch_list=[loss], scope=sb)
    ckpt = os.path.join(c.args["out"], "ckpt")
    io.save_persistables(exe, ckpt, main_program=main, scope=sb)
    files = sorted(os.listdir(ckpt))
    sc = fluid.Scope()
    io.load_persistables(exe, ckpt, main_program=main, scope=sc)
    loaded_equal = all(torch.equal(sc.find_var(p.name), sb.find_var(p.name))
                       for p in main.all_parameters())
    resumed = [exe.run(comp, feed=f, fetch_list=[loss], scope=sc)[0]
               for f in feeds[2:]]
    tc = train.TrainCheckpoint(os.path.join(c.args["out"], "tc"))
    no = tc.save(exe, program=main, scope=sc, train_state={"step": 4})
    sd = fluid.Scope()
    got, st = tc.restore_latest(exe, program=main, scope=sd)
    return {"base": np.array(base), "resumed": np.array(resumed)}, {
        "resume_bitwise": bool(np.array_equal(np.array(base[2:]),
                                              np.array(resumed))),
        "scope_bitwise": _same(state(sa), state(sc)),
        "loaded_equal": loaded_equal, "files": len(files),
        "tc_no": no, "tc_restored": got, "tc_state": st.get("step"),
        "tc_bitwise": _same(state(sc), state(sd))}


def sc_ckpt_fault(c):
    """A CheckpointSaver.save whose commit fails on rank 0 (the io.commit
    fault point armed there only) raises on every rank; the next save
    then works on every rank, with one number (no rank waits alone)."""
    import contextlib
    from paddle_tpu_torch import io, resilience
    main, startup, loss = c.build(bn_classifier)
    exe, scope = c.scope(startup, "bn")
    saver = io.CheckpointSaver(os.path.join(c.args["out"], "saver"))
    arm = resilience.fault_injection(
        "io.commit", OSError(28, "No space left on device")) \
        if c.rank == 0 else contextlib.nullcontext()
    raised = None
    with arm:
        try:
            saver.save(exe, main_program=main, scope=scope)
        except Exception as e:  # noqa: BLE001 — the test reads its type
            raised = f"{type(e).__name__}: {e}"
    no = saver.save(exe, main_program=main, scope=scope)
    return {}, {"raised": raised, "no": no,
                "numbers": saver.checkpoint_numbers()}


def sc_seeds(c):
    """Each rank's startup from its own seed: the first data-parallel
    run broadcasts rank 0's state, so every rank ends equal."""
    fluid = c.fluid
    main, startup, loss = c.build(bn_classifier, seed=11 + c.rank)
    exe = fluid.Executor(c.place)
    scope = fluid.Scope()
    exe.run(startup, scope=scope)
    before = params(fluid, main, scope)
    comp = fluid.CompiledProgram(main).with_data_parallel(
        loss_name=loss.name)
    for f in classifier_feeds(2):
        exe.run(comp, feed=rows(f, c.rank, c.n), fetch_list=[loss],
                scope=scope)
    out = {f"before/{k}": v for k, v in before.items()}
    out.update(state(scope))
    from paddle_tpu_torch.framework.executor import RNG_STATE_NAME
    return out, {"run_seed": str(scope.find_var(RNG_STATE_NAME))}


def sc_nonfinite(c):
    """A NaN in rank 1's rows of step 2 only: skip_nonfinite_steps rolls
    step 2 back on every rank (run and run_steps alike)."""
    fluid = c.fluid
    main, startup, loss = c.build(bn_classifier)
    comp = fluid.CompiledProgram(main).with_data_parallel(
        loss_name=loss.name)
    feeds = [rows(f, c.rank, c.n) for f in classifier_feeds(4, seed=5)]
    if c.rank == 1:
        feeds[2] = dict(feeds[2], x=feeds[2]["x"].copy())
        feeds[2]["x"][0, 0] = np.nan
    exe, s1 = c.scope(startup, "bn")
    _, s2 = c.scope(startup, "bn")
    _, s3 = c.scope(startup, "bn")
    for f in feeds:
        exe.run(comp, feed=f, fetch_list=[loss], scope=s1,
                skip_nonfinite_steps=True)
    exe.run_steps(comp, feed=feeds, fetch_list=[loss], scope=s2,
                  skip_nonfinite_steps=True)
    clean = feeds[:2] + feeds[3:]
    for f in clean:
        exe.run(comp, feed=f, fetch_list=[loss], scope=s3)
    out = state(s1)
    return out, {"run_vs_steps": _same(state(s1), state(s2)),
                 "rolled_back": _same(state(s1), state(s3))}


def sc_dataset(c):
    """train_from_dataset through a CompiledProgram (slabs of 2 and a
    tail, by run_steps and run) against one run per batch, each rank
    reading a file of its own rows."""
    fluid = c.fluid
    main, startup, loss = c.build(bn_classifier)
    comp = fluid.CompiledProgram(main).with_data_parallel(
        loss_name=loss.name)
    path = os.path.join(c.args["out"], f"rows.{c.rank}.txt")
    lines = []
    for f in classifier_feeds(5, seed=9):
        mine = rows(f, c.rank, c.n)
        for x, y in zip(mine["x"], mine["y"]):
            lines.append(f"x:{','.join(map(repr, x.tolist()))} "
                         f"y:{int(y[0])}")
    with open(path, "w") as f:
        f.write("\n".join(lines) + "\n")
    block = main.global_block()
    ds = fluid.DatasetFactory().create_dataset("QueueDataset")
    ds.set_filelist([path])
    ds.set_batch_size(B_GLOBAL // c.n)
    ds.set_use_var([block.var("x"), block.var("y")])
    exe, sa = c.scope(startup, "bn")
    _, sb = c.scope(startup, "bn")
    exe.train_from_dataset(comp, ds, scope=sa, fetch_list=[loss],
                           steps_per_run=2, print_period=0)
    batches = list(ds.batch_iterator())
    for b in batches:
        exe.run(comp, feed=b, fetch_list=[loss], scope=sb)
    return state(sa), {"batches": len(batches),
                       "bitwise": _same(state(sa), state(sb))}


def sc_crash(c):
    """Rank 2 raises in its second step; the others go on into the
    step's collectives. The launch must end non-zero."""
    main, startup, loss = c.build(bn_classifier)
    exe, scope = c.scope(startup, "bn")
    comp = c.fluid.CompiledProgram(main).with_data_parallel(
        loss_name=loss.name)
    for i, f in enumerate(classifier_feeds(4)):
        if i == 1 and c.rank == 2:
            raise RuntimeError("rank 2 fails mid-step")
        exe.run(comp, feed=rows(f, c.rank, c.n), fetch_list=[loss],
                scope=scope)
    return {}, {}


def sc_fleet_mlp(c):
    """``dist_fleet_runner.py`` at 4 ranks: SGD(0.1) through
    ``fleet.distributed_optimizer`` and ``fleet.main_program``."""
    fluid = c.fluid
    from paddle_tpu_torch.framework.executor import scope_from_arrays
    from paddle_tpu_torch.incubate.fleet.base.role_maker import (
        PaddleCloudRoleMaker)
    from paddle_tpu_torch.incubate.fleet.collective import (
        DistributedStrategy, fleet)
    fleet.init(PaddleCloudRoleMaker(is_collective=True))
    main, startup = fluid.Program(), fluid.Program()
    with fluid.unique_name.guard(), fluid.program_guard(main, startup):
        loss = fleet_mlp(fluid)
        opt = fleet.distributed_optimizer(fluid.optimizer.SGD(0.1),
                                          strategy=DistributedStrategy())
        opt.minimize(loss)
    exe = fluid.Executor(c.place)
    scope = fluid.Scope()
    start = c.start("fleet_mlp")
    if c.rank:         # only rank 0's start counts: the broadcast
        start = {k: v + np.float32(c.rank) for k, v in start.items()}
    exe.run(fleet.startup_program, scope=scope)
    scope_from_arrays(scope, start)
    losses = [float(exe.run(fleet.main_program, feed=rows(f, c.rank, c.n),
                            fetch_list=[loss], scope=scope)[0])
              for f in fleet_feeds()]
    types = [op.type for op in fleet.startup_program.global_block().ops]
    out = {"losses": np.array(losses)}
    out.update(state(scope))
    return out, {"worker_index": fleet.worker_index(),
                 "worker_num": fleet.worker_num(),
                 "first": fleet.is_first_worker(),
                 "startup_broadcasts": types.count("c_broadcast")}


def sc_fleet_startup(c):
    """``fleet.startup_program`` on its own: each rank's startup from its
    own seed, ending equal by the broadcast at its end."""
    fluid = c.fluid
    from paddle_tpu_torch.incubate.fleet.collective import fleet
    fleet.init()
    main, startup = fluid.Program(), fluid.Program()
    main.random_seed = startup.random_seed = 3 + c.rank
    with fluid.unique_name.guard(), fluid.program_guard(main, startup):
        loss = bn_classifier(fluid)
        fleet.distributed_optimizer(fluid.optimizer.SGD(0.1)) \
            .minimize(loss)
    exe = fluid.Executor(c.place)
    scope = fluid.Scope()
    exe.run(fleet.startup_program, scope=scope)
    return state(scope), {}


def sc_fleet_bert(c):
    """Tiny BERT (dropout 0) through Fleet, Adam at a constant 1e-3, 2
    steps on each rank's sequences."""
    fluid = c.fluid
    from paddle_tpu_torch.framework.executor import scope_from_arrays
    from paddle_tpu_torch.incubate.fleet.collective import fleet
    from paddle_tpu_torch.models import bert
    fleet.init()
    main, startup = fluid.Program(), fluid.Program()
    main.random_seed = startup.random_seed = 7
    with fluid.unique_name.guard(), fluid.program_guard(main, startup):
        out = bert_tiny(fluid, bert)
        fleet.distributed_optimizer(fluid.optimizer.AdamOptimizer(1e-3)) \
            .minimize(out["loss"])
    exe = fluid.Executor(c.place)
    scope = fluid.Scope()
    exe.run(fleet.startup_program, scope=scope)
    scope_from_arrays(scope, c.start("bert"))
    losses = [float(exe.run(fleet.main_program,
                            feed=bert_rows(f, c.rank, c.n),
                            fetch_list=[out["loss"]], scope=scope)[0])
              for f in bert_feeds(bert)]
    res = {"losses": np.array(losses)}
    res.update(state(scope))
    return res, {}


def sc_fleet_ckpt(c):
    """Fleet's save_checkpoint (rank 0 writes) and load_checkpoint
    (every rank reads) with a TrainStatus, and save_persistables."""
    fluid = c.fluid
    from paddle_tpu_torch.incubate.fleet.collective import (TrainStatus,
                                                             fleet)
    fleet.init()
    main, startup = fluid.Program(), fluid.Program()
    with fluid.unique_name.guard(), fluid.program_guard(main, startup):
        loss = fleet_mlp(fluid)
        fleet.distributed_optimizer(fluid.optimizer.SGD(0.1)) \
            .minimize(loss)
    exe = fluid.Executor(c.place)
    scope = fluid.Scope()
    with fluid.scope_guard(scope):
        exe.run(fleet.startup_program)
        for f in fleet_feeds(2):
            exe.run(fleet.main_program, feed=rows(f, c.rank, c.n),
                    fetch_list=[loss])
        path = os.path.join(c.args["out"], "fleet_ckpt")
        fleet.save_checkpoint(exe, path, TrainStatus(3))
        fleet.save_persistables(exe, os.path.join(c.args["out"],
                                                  "fleet_persist"))
        fresh = fluid.Scope()
        with fluid.scope_guard(fresh):
            status = fleet.load_checkpoint(exe, path)
            same = _same(state(fresh), state(scope))
    return {}, {"status": status._epoch_no, "equal": same,
                "checkpoints": len([d for d in os.listdir(path)
                                    if not d.endswith(".tmp")])}


def dy_mlp(dy):
    class MLP(dy.Layer):
        def __init__(self):
            super().__init__()
            self.l1 = dy.Linear(6, 16, act="tanh")
            self.l2 = dy.Linear(16, 3)

        def forward(self, x):
            return self.l2(self.l1(x))
    return MLP()


def dy_feeds(steps=STEPS):
    rng = np.random.default_rng(17)
    return [(rng.standard_normal((B_GLOBAL, 6)).astype("float32"),
             (rng.standard_normal((B_GLOBAL, 3)) * 0.5).astype("float32"))
            for _ in range(steps)]


def sc_wd(c):
    """Wide&Deep under each of ``WD_CASES``, 3 steps on the rank's rows
    of the global batches: the gathered state, the losses, the ops the
    rewrite made, the rank's table shard shape; "oob_lazy" also keeps
    the gathered state after step 1; "dp2mp2" saves the trained model
    (gathered) for the test to load at one card and in the JAX
    package."""
    from paddle_tpu_torch.models import widedeep
    from paddle_tpu_torch.parallel import mesh
    from paddle_tpu_torch.parallel.tp import gathered
    fluid = c.fluid
    out, flags = {}, {}

    def whole(main, scope):
        with gathered(scope):
            return {v.name: np.array(scope.find_var(v.name).numpy())
                    for v in main.list_vars() if v.persistable
                    and hasattr(scope.find_var(v.name), "numpy")}

    for name, axes, lazy, dist, kind, how in WD_CASES:
        grid = mesh.make_mesh(mesh.MeshConfig(**axes))
        # the data coordinate over dcn_dp x dp (dcn-major)
        d, n = grid.coords()[mesh.DATA_AXIS], grid.dcn_dp * grid.dp
        main, startup, loss = c.build(wide_deep, widedeep, lazy, dist)
        exe, scope = c.scope(startup, "wd")
        comp = fluid.CompiledProgram(main).with_data_parallel(
            loss_name=loss.name, mesh=grid)
        feeds = [rows(f, d, n) for f in wd_feeds(widedeep, kind)]
        losses = []
        if how == "steps":
            fused, = exe.run_steps(comp, feed=feeds, fetch_list=[loss],
                                   scope=scope)
            losses = [float(v) for v in np.asarray(fused).reshape(-1)]
            rep = comp.hier_report
            flags[f"{name}/gate"] = {
                "violations": rep["violations"], "rows": rep["rows"],
                "sparse": rep["sparse_cross_slice_wire_bytes"],
                "cross": rep["cross_slice_wire_bytes"],
                "flat": rep["flat_estimate_wire_bytes"]}
        for i, f in enumerate(feeds if how == "run" else ()):
            losses.append(float(np.ravel(exe.run(
                comp, feed=f, fetch_list=[loss], scope=scope)[0])[0]))
            if name == "oob_lazy" and i == 0:
                for k, v in whole(main, scope).items():
                    out[f"{name}/step1/{k}"] = v
        for k, v in whole(main, scope).items():
            out[f"{name}/{k}"] = v
        out[f"{name}/losses"] = np.array(losses)
        types = [o.type for o in comp.program.global_block().ops]
        flags[name] = {
            "coords": grid.coords(), "data": d,
            "hier": types.count("hier_allreduce"),
            "allgathers": types.count("c_allgather_selected_rows"),
            "c_embedding": types.count("c_embedding"),
            "table_local": list(scope.find_var("embedding_0.w").shape),
            "moment_local": list(scope.find_var(next(
                v.name for v in main.list_vars()
                if v.name.startswith("embedding_0.w_moment1"))).shape)}
        if name == "dp2mp2":
            ckpt = os.path.join(c.args["out"], "wd_ckpt")
            fluid.io.save_persistables(exe, ckpt, main_program=main,
                                       scope=scope)
            flags["ckpt"] = ckpt
    return out, flags


def dy_emb(dy):
    """A sparse ``Embedding`` (64 x 8) summed over each row's ids into a
    ``Linear`` to one output."""
    class EmbMLP(dy.Layer):
        def __init__(self):
            super().__init__()
            self.emb = dy.Embedding([64, 8], is_sparse=True)
            self.fc = dy.Linear(8, 1)

        def forward(self, ids):
            return self.fc(self.emb(ids))
    return EmbMLP()


def dy_emb_feeds(steps=STEPS):
    rng = np.random.default_rng(19)
    return [(rng.integers(0, 64, (B_GLOBAL,)).astype("int64"),
             rng.standard_normal((B_GLOBAL, 1)).astype("float32"))
            for _ in range(steps)]


def sc_dy_sparse(c):
    """The sparse-Embedding model under DataParallel, 3 Adam steps (its
    grads are dense in both packages: dygraph ``Embedding`` ignores
    ``is_sparse``, as the JAX package's does); then a ``SelectedRows``
    grad set on a parameter, all-gathered by ``apply_collective_grads``
    (rank r's rows r and 10 + r, values r + 1)."""
    import torch
    fluid = c.fluid
    from paddle_tpu_torch import dygraph as dy
    from paddle_tpu_torch.framework.selected_rows import SelectedRows
    from paddle_tpu_torch.models import layer_params_from_jax
    out = {}
    with dy.guard(c.place):
        model = dy_emb(dy)
        layer_params_from_jax(model, c.start("dy_emb"))
        model = dy.DataParallel(model, dy.prepare_context())
        opt = fluid.optimizer.Adam(0.01, parameter_list=model.parameters())
        losses = []
        b = B_GLOBAL // c.n
        sl = slice(c.rank * b, (c.rank + 1) * b)
        for ids, y in dy_emb_feeds():
            loss = fluid.layers.mean(fluid.layers.square(
                fluid.layers.elementwise_sub(
                    model(dy.to_variable(ids[sl])), dy.to_variable(y[sl]))))
            loss = model.scale_loss(loss)
            loss.backward()
            model.apply_collective_grads()
            opt.minimize(loss)
            model.clear_gradients()
            losses.append(float(loss.numpy().reshape(-1)[0]) * c.n)
        out["losses"] = np.array(losses)
        for k, v in model.state_dict().items():
            out[k] = np.array(v)
        p = model.parameters()[0]
        p._grad = SelectedRows(torch.tensor([c.rank, 10 + c.rank]),
                               torch.full((2, 8), float(c.rank + 1)))
        model.apply_collective_grads()
        out["sr/rows"] = p._grad.rows.numpy()
        out["sr/values"] = p._grad.values.numpy()
    return out, {}


def sc_dy_mlp(c):
    """The dygraph MLP under DataParallel, 3 Adam steps: eagerly, and by
    jit_step (the all-reduce inside the step)."""
    fluid = c.fluid
    from paddle_tpu_torch import dygraph as dy
    from paddle_tpu_torch.models import layer_params_from_jax
    start = c.start("dy_mlp")
    out = {}
    for mode in ("eager", "jit"):
        with dy.guard(c.place):
            model = dy_mlp(dy)
            if c.rank:       # rank 0's weights reach every rank
                layer_params_from_jax(model, {k: v * 0.5
                                              for k, v in start.items()})
            else:
                layer_params_from_jax(model, start)
            model = dy.DataParallel(model, dy.prepare_context())
            opt = fluid.optimizer.Adam(0.01,
                                       parameter_list=model.parameters())

            def step(x, y):
                loss = fluid.layers.mean(fluid.layers.square(
                    fluid.layers.elementwise_sub(model(x), y)))
                loss = model.scale_loss(loss)
                loss.backward()
                model.apply_collective_grads()
                opt.minimize(loss)
                model.clear_gradients()
                return loss

            run = dy.jit_step(step) if mode == "jit" else step
            losses = []
            for x, y in dy_feeds():
                b = B_GLOBAL // c.n
                sl = slice(c.rank * b, (c.rank + 1) * b)
                losses.append(float(run(dy.to_variable(x[sl]),
                                        dy.to_variable(y[sl])).numpy()
                                    .reshape(-1)[0]))
            out[f"{mode}/losses"] = np.array(losses) * c.n
            for k, v in model.state_dict().items():
                out[f"{mode}/{k}"] = np.array(v)
    return out, {}


SCENARIOS = {n[3:]: f for n, f in globals().items() if n.startswith("sc_")}


def main(path):
    with open(path) as f:
        args = json.load(f)
    c = Ctx(args)
    for name in args["scenarios"]:
        arrays, flags = SCENARIOS[name](c)
        arrays = dict(arrays)
        arrays["__flags__"] = np.array(json.dumps(flags))
        np.savez(os.path.join(args["out"], f"{name}.{c.rank}.npz"),
                 **arrays)
    # every rank is done writing before any rank leaves the world
    from paddle_tpu_torch.parallel import mesh
    mesh.barrier()


if __name__ == "__main__":
    main(sys.argv[1])
