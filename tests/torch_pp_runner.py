"""Worker of the port's pipeline-parallel CPU tests
(``test_torch_pipeline_parallel.py``): one rank of a gloo world of 4
started by ``python -m paddle_tpu_torch.distributed.launch
--nproc_per_node=4 --device=cpu`` (or of 8, for ``GRIDS8``). It trains a
narrow 4-layer GPT whose decoder layers sit in a ``layers.Pipeline`` on
each grid of ``args["grids"]`` (default ``GRIDS``): pp 4 (4 stages of 1
layer), pp 2 x dp 2 (2 stages of 2 layers, ranks 0, 1 stage 0 and
ranks 2, 3 stage 1), a pp 4 mesh under a pipeline of 2 stages
(``num_stages`` != pp: the sequential path on every rank), pp 2 x tp 2
and pp 2 x sp 2 (every tp or sp rank of a stage runs it whole); pp 2 x
tp 2 x dp 2 on 8 ranks.

    python torch_pp_runner.py <args.json>

``args``: ``{"out": dir, "start": {"s4": npz, "s2": npz}, "grids":
[...], "plain": bool}``, the JAX package's startup values of the 4- and
2-stage programs (the tp and sp grids' programs differ only in
annotations). Each grid
trains 3 Adam steps eagerly and by a ``run_steps`` slab from the same
start; rank 0 also trains the one-process program of the whole batch
and saves the pp 4 run's persistables (gathered whole) under
``<out>/save_pp4``. Everything a rank saw goes to
``<out>/train.<rank>.npz`` (``__flags__``: a JSON of its booleans and
numbers). The builder takes either package's ``fluid`` and ``gpt``, so
the test builds the JAX reference from the same function. This module
imports the port only (the ranks never import JAX).
"""
import json
import os
import sys

import numpy as np

CFG = dict(vocab_size=128, hidden_size=32, num_layers=4, num_heads=2,
           ffn_size=64, max_position=64, dropout=0.0)
B, SEQ, STEPS, LR = 8, 16, 3, 1e-3
# grid -> (mesh axes, num_stages, microbatches of the rank's rows); each
# microbatch holds 2 rows, as in the reference's 4 microbatches of 8. A
# tp grid annotates the word embedding ("tp", None) as
# gpt.apply_tp_sharding does, an sp grid pins the embeddings' output to
# ("dp", "sp", None); both stay outside the pipeline
GRIDS = {"pp4": ({"pp": 4}, 4, 4), "pp2dp2": ({"pp": 2, "dp": 2}, 2, 2),
         "pp4_stages2": ({"pp": 4}, 2, 4),
         "pp2tp2": ({"pp": 2, "tp": 2}, 2, 4),
         "pp2sp2": ({"pp": 2, "sp": 2}, 2, 4)}
# the grids of the 8-rank launch (test_torch_pipeline_tp.py)
GRIDS8 = {"pp2tp2dp2": ({"pp": 2, "tp": 2, "dp": 2}, 2, 2)}
ALL_GRIDS = dict(GRIDS, **GRIDS8)


def gpt_pipeline(fluid, gpt, cfg, rows, seq, stages, micro, lr=LR,
                 tp=False, sp=False):
    """GPT pretraining (``gpt_pretrain``'s body) with its decoder layers
    in a ``layers.Pipeline`` of ``stages`` uniform stages of
    ``num_layers / stages`` layers each, over ``micro`` microbatches;
    Adam through ``PipelineOptimizer``. ``tp``: the word embedding (and
    so the tied head) annotated ``("tp", None)``; ``sp``: the pipeline's
    input pinned to ``("dp", "sp", None)``. Returns the loss."""
    L, T = fluid.layers, fluid.layers
    init = fluid.initializer
    h = cfg.hidden_size

    def normal(name):
        return fluid.ParamAttr(name=name, initializer=init.Normal(
            0.0, cfg.initializer_range))

    def ln(x, name):
        return L.layer_norm(
            x, begin_norm_axis=2,
            param_attr=fluid.ParamAttr(name=f"{name}_scale",
                                       initializer=init.Constant(1.0)),
            bias_attr=fluid.ParamAttr(name=f"{name}_bias",
                                      initializer=init.Constant(0.0)))

    tokens = T.data("tokens", [rows, seq], dtype="int32")
    labels = T.data("labels", [rows, seq], dtype="int32")
    loss_mask = T.data("loss_mask", [rows, seq], dtype="float32")
    pos_ids = T.data("pos_ids", [rows, seq], dtype="int32")
    emb = L.embedding(tokens, size=[cfg.vocab_size, h],
                      param_attr=normal("word_embedding"))
    pos = L.embedding(pos_ids, size=[cfg.max_position, h],
                      param_attr=normal("pos_embedding"))
    x = L.dropout(L.elementwise_add(emb, pos), cfg.dropout,
                  dropout_implementation="upscale_in_train")
    if sp:
        x = L.collective.shard(x, "dp", "sp", None)
    pipe = L.Pipeline(num_stages=stages, num_microbatches=micro)
    with pipe.stage():
        y = pipe.stage_input(x)
        for i in range(cfg.num_layers // stages):
            y = gpt.decoder_layer(cfg, y, i, False)
        pipe.stage_output(y)
    x = ln(pipe(), "final_ln")
    word_emb = x.block.program.global_block().var("word_embedding")
    logits = L.matmul(T.reshape(x, [-1, h]), word_emb, transpose_y=True)
    ce = L.softmax_with_cross_entropy(logits, T.reshape(labels, [-1, 1]))
    w = T.reshape(loss_mask, [-1, 1])
    loss = L.elementwise_div(
        L.reduce_sum(L.elementwise_mul(ce, w)),
        L.elementwise_add(L.reduce_sum(w),
                          T.fill_constant([1], "float32", 1e-9)))
    if tp:
        fluid.parallel.mesh.set_param_dist_attr(
            x.block.program, "word_embedding", ("tp", None))
    fluid.optimizer.PipelineOptimizer(
        fluid.optimizer.Adam(lr), num_microbatches=micro).minimize(loss)
    return loss


def config(gpt):
    return gpt.GPTConfig(**CFG)


def feeds(gpt, steps=STEPS, seed=70):
    return [gpt.random_batch(config(gpt), B, SEQ,
                             rng=np.random.default_rng(seed + i))
            for i in range(steps)]


def rows(feed, d, n):
    b = B // n
    return {k: v[d * b:(d + 1) * b] for k, v in feed.items()}


def program(fluid, gpt, rows_, stages, micro, seed=7, tp=False,
            sp=False):
    main, startup = fluid.Program(), fluid.Program()
    main.random_seed = startup.random_seed = seed
    with fluid.unique_name.guard(), fluid.program_guard(main, startup):
        loss = gpt_pipeline(fluid, gpt, config(gpt), rows_, SEQ, stages,
                            micro, tp=tp, sp=sp)
    return main, startup, loss


def grid_program(fluid, gpt, name, rows_):
    """``name``'s program at ``rows_`` rows a rank."""
    axes, stages, micro = ALL_GRIDS[name]
    return program(fluid, gpt, rows_, stages, micro,
                   tp=axes.get("tp", 1) > 1, sp=axes.get("sp", 1) > 1)


# ------------------------------------------------------------- the rank

def _scope(fluid, exe, startup, start):
    from paddle_tpu_torch.framework.executor import scope_from_arrays
    scope = fluid.Scope()
    exe.run(startup, scope=scope)
    scope_from_arrays(scope, start)
    return scope


def _losses(vals):
    return [float(np.ravel(v)[0]) for v in vals]


def train(c, name):
    fluid, gpt, mesh = c.fluid, c.gpt, c.mesh
    axes, stages, _ = ALL_GRIDS[name]
    grid = mesh.make_mesh(mesh.MeshConfig(**axes))
    d, n = grid.coords()["dp"], grid.dp
    main, startup, loss = grid_program(fluid, gpt, name, B // n)
    comp = fluid.CompiledProgram(main).with_data_parallel(
        loss_name=loss.name, mesh=grid)
    exe = fluid.Executor(c.place)
    start = c.start(f"s{stages}")
    fs = [rows(f, d, n) for f in feeds(gpt)]
    sA, sB = (_scope(fluid, exe, startup, start) for _ in range(2))
    eager = _losses(exe.run(comp, feed=f, fetch_list=[loss], scope=sA)[0]
                    for f in fs)
    slab = exe.run_steps(comp, feed=fs, fetch_list=[loss], scope=sB)[0]
    out, flags = {}, {"coords": grid.coords(), "losses": eager}
    flags["slab_bitwise"] = bool(np.array_equal(
        np.asarray(eager, np.float32), np.ravel(slab))) and all(
        np.array_equal(v.numpy(), sB.find_var(k).numpy())
        for k, v in sA.items() if hasattr(v, "numpy"))
    params = [p.name for p in main.all_parameters()]
    stacked = [p for p in params
               if main.global_block().var(p).dist_attr == ("pp",)]
    flags["stacked"] = stacked
    flags["slices"] = sorted(getattr(comp.program, "_pp_layouts", {}))
    for p in params:
        out[f"local/{p}"] = sA.find_var(p).numpy()
    from paddle_tpu_torch.parallel.tp import gathered
    with gathered(sA):
        for p in params:
            out[f"whole/{p}"] = sA.find_var(p).numpy().copy()
    if name == "pp4":
        fluid.io.save_persistables(exe, os.path.join(c.args["out"],
                                                     "save_pp4"),
                                   main_program=main, scope=sA)
        # after the save the scope still holds the slices
        flags["slices_kept"] = all(
            sA.find_var(p).shape[0] == 1 for p in stacked)
    return out, flags


def plain(c, stages, micro):
    """The one-process program of the whole batch (no mesh: the
    sequential path)."""
    fluid, gpt = c.fluid, c.gpt
    main, startup, loss = program(fluid, gpt, B, stages, micro)
    exe = fluid.Executor(c.place)
    scope = _scope(fluid, exe, startup, c.start(f"s{stages}"))
    losses = _losses(exe.run(main, feed=f, fetch_list=[loss],
                             scope=scope)[0] for f in feeds(gpt))
    return {p.name: scope.find_var(p.name).numpy()
            for p in main.all_parameters()}, losses


class Ctx:
    def __init__(self, args):
        import torch
        torch.set_num_threads(1)
        import paddle_tpu_torch as fluid
        from paddle_tpu_torch.models import gpt
        from paddle_tpu_torch.parallel import mesh
        self.fluid, self.gpt, self.mesh = fluid, gpt, mesh
        self.args = args
        mesh.init_parallel_env()
        self.rank = mesh.rank()
        self.place = fluid.CPUPlace()

    def start(self, key):
        with np.load(self.args["start"][key]) as z:
            return {k: z[k] for k in z.files}


def main(path):
    with open(path) as f:
        args = json.load(f)
    c = Ctx(args)
    arrays, flags = {}, {}
    for name in args.get("grids", GRIDS):
        out, fl = train(c, name)
        arrays.update({f"{name}/{k}": v for k, v in out.items()})
        flags[name] = fl
    if c.rank == 0 and args.get("plain", True):
        for stages in (4, 2):
            params, losses = plain(c, stages, 4)
            arrays.update({f"plain{stages}/{k}": v
                           for k, v in params.items()})
            flags[f"plain{stages}"] = {"losses": losses}
    arrays["__flags__"] = np.array(json.dumps(flags))
    np.savez(os.path.join(args["out"], f"train.{c.rank}.npz"), **arrays)
    c.mesh.barrier()


if __name__ == "__main__":
    main(sys.argv[1])
