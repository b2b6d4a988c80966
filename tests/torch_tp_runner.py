"""Worker of the port's tensor-parallel CPU tests
(``test_torch_tensor_parallel.py``): one rank of a gloo world of 4
started by ``python -m paddle_tpu_torch.distributed.launch
--nproc_per_node=4 --device=cpu``, laid out as dp 2 x tp 2 (ranks 0 and
1 are one tp group, 2 and 3 the other).

    python torch_tp_runner.py <args.json>

``args``: ``{"out": dir, "scenarios": [names], "start": {model: npz
path}}``. Each scenario writes ``<out>/<scenario>.<rank>.npz`` (its
arrays; ``__flags__`` holds a JSON of its booleans and numbers). The
model builders take either package's ``fluid`` and model module, so a
test builds the JAX reference from the same function; the JAX package's
startup values reach the ranks through the ``start`` files. Every dp
rank is fed its rows of one global batch made here from a seed. This
module imports the port only (the ranks never import JAX).
"""
import json
import os
import sys

import numpy as np

STEPS = 3
BERT = {"B": 4, "S": 16, "P": 3}
GPT = {"B": 4, "S": 16}
TP = 2


# ----------------------------------------------------------------- models

def bert_cfg(bert, dropout=0.0):
    cfg = bert.BertConfig.tiny()
    cfg.hidden_dropout = cfg.attn_dropout = dropout
    return cfg


def gpt_cfg(gpt, dropout=0.0):
    cfg = gpt.GPTConfig.tiny()
    cfg.dropout = dropout
    return cfg


def optimizer(fluid, opt, checkpoints=None):
    """``opt``'s optimizer: "adam" (1e-3), "recompute" (that Adam under
    ``RecomputeOptimizer`` with the model's layer checkpoints), "lamb"
    (1e-3, under a global-norm clip at 1.0, as bert_lamb trains) or
    "lars" (0.01, momentum 0.9)."""
    O = fluid.optimizer
    if opt == "recompute":
        rc = O.RecomputeOptimizer(O.AdamOptimizer(1e-3))
        rc._set_checkpoints(checkpoints)
        return rc
    return {"adam": lambda: O.AdamOptimizer(1e-3),
            "lamb": lambda: O.LambOptimizer(
                1e-3, grad_clip=fluid.clip.GradientClipByGlobalNorm(1.0)),
            "lars": lambda: O.LarsMomentumOptimizer(0.01, 0.9)}[opt]()


def build_bert(fluid, bert, rows, dropout=0.0, tp=True, opt="adam"):
    """BERT-tiny pretraining at ``rows`` sequences, annotated for tp,
    under ``opt`` (:func:`optimizer`)."""
    cfg = bert_cfg(bert, dropout)
    out = bert.bert_pretrain(cfg, rows, BERT["S"], BERT["P"])
    if tp:
        bert.apply_tp_sharding(out["loss"].block.program, cfg)
    optimizer(fluid, opt, out["checkpoints"]).minimize(out["loss"])
    return out["loss"]


def build_gpt(fluid, gpt, rows, tp=True):
    cfg = gpt_cfg(gpt)
    out = gpt.gpt_pretrain(cfg, rows, GPT["S"])
    if tp:
        gpt.apply_tp_sharding(out["loss"].block.program, cfg)
    fluid.optimizer.AdamOptimizer(1e-3).minimize(out["loss"])
    return out["loss"]


# ----------------------------------------------------------------- feeds

def bert_feeds(bert, steps=STEPS, seed=40):
    cfg = bert_cfg(bert)
    return [bert.random_batch(cfg, BERT["B"], BERT["S"], BERT["P"],
                              rng=np.random.default_rng(seed + i))
            for i in range(steps)]


def gpt_feeds(gpt, steps=STEPS, seed=60):
    cfg = gpt_cfg(gpt)
    return [gpt.random_batch(cfg, GPT["B"], GPT["S"],
                             rng=np.random.default_rng(seed + i))
            for i in range(steps)]


def bert_rows(feed, d, n):
    """dp rank ``d``'s sequences of a BERT batch (``mask_pos`` re-based
    on its first sequence)."""
    b = BERT["B"] // n
    out = {k: feed[k][d * b:(d + 1) * b]
           for k in ("src_ids", "sent_ids", "pos_ids", "input_mask",
                     "labels")}
    pos = feed["mask_pos"].reshape(BERT["B"], BERT["P"])[d * b:(d + 1) * b]
    out["mask_pos"] = (pos - d * b * BERT["S"]).reshape(-1)
    out["mask_label"] = feed["mask_label"][d * b * BERT["P"]:
                                           (d + 1) * b * BERT["P"]]
    return out


def gpt_rows(feed, d, n):
    b = GPT["B"] // n
    return {k: v[d * b:(d + 1) * b] for k, v in feed.items()}


# ------------------------------------------------------------- scenarios

class Ctx:
    def __init__(self, args):
        import torch
        torch.set_num_threads(1)
        import paddle_tpu_torch as fluid
        from paddle_tpu_torch.models import bert, gpt
        from paddle_tpu_torch.parallel import mesh
        self.fluid, self.bert, self.gpt, self.mesh = fluid, bert, gpt, mesh
        self.args = args
        mesh.init_parallel_env()
        self.rank = mesh.rank()
        self.grid = mesh.make_mesh(mesh.MeshConfig(dp=2, tp=TP))
        self.dp = self.grid.coords()["dp"]
        self.place = fluid.CPUPlace()

    def start(self, model):
        with np.load(self.args["start"][model]) as z:
            return {k: z[k] for k in z.files}

    def program(self, fn, *a, seed=7, **kw):
        fluid = self.fluid
        main, startup = fluid.Program(), fluid.Program()
        main.random_seed = startup.random_seed = seed
        with fluid.unique_name.guard(), fluid.program_guard(main, startup):
            loss = fn(fluid, *a, **kw)
        return main, startup, loss

    def compiled(self, main, loss):
        return self.fluid.CompiledProgram(main).with_data_parallel(
            loss_name=loss.name, mesh=self.grid)

    def scope(self, startup, model):
        from paddle_tpu_torch.framework.executor import scope_from_arrays
        exe = self.fluid.Executor(self.place)
        scope = self.fluid.Scope()
        exe.run(startup, scope=scope)
        scope_from_arrays(scope, self.start(model))
        return exe, scope


def whole_state(c, main, scope):
    """Every persistable of ``main``, gathered to its whole shape."""
    from paddle_tpu_torch.parallel.tp import gathered
    with gathered(scope):
        return {v.name: np.array(scope.find_var(v.name).numpy())
                for v in main.list_vars() if v.persistable
                and scope.find_var(v.name) is not None
                and hasattr(scope.find_var(v.name), "numpy")}


def local_state(main, scope):
    return {"local/" + v.name: np.array(scope.find_var(v.name).numpy())
            for v in main.list_vars() if v.persistable
            and hasattr(scope.find_var(v.name), "numpy")}


def train(c, kind, steps=STEPS, dropout=0.0, opt="adam"):
    bert = kind == "bert"
    build = build_bert if bert else build_gpt
    model = c.bert if bert else c.gpt
    kw = {"dropout": dropout, "opt": opt} if bert else {}
    main, startup, loss = c.program(build, model, BERT["B"] // 2
                                    if bert else GPT["B"] // 2, **kw)
    exe, scope = c.scope(startup, kind if opt == "adam" else f"bert_{opt}")
    prog = c.compiled(main, loss)
    feeds = (bert_feeds if bert else gpt_feeds)(model, steps)
    split = bert_rows if bert else gpt_rows
    losses = [float(np.ravel(exe.run(prog, feed=split(f, c.dp, 2),
                                     fetch_list=[loss], scope=scope)[0])[0])
              for f in feeds]
    return main, prog, exe, scope, losses, loss


def sc_bert(c):
    main, prog, exe, scope, losses, _ = train(c, "bert")
    out = whole_state(c, main, scope)
    out.update(local_state(main, scope))
    out["losses"] = np.array(losses)
    moment = next(n for n in out if n.startswith(
        "local/encoder_layer_0_multi_head_att_qkv.w_0_moment1"))
    report = prog.program._tp_report
    return out, {"moment": moment, "report": report}


def sc_gpt(c):
    main, prog, exe, scope, losses, _ = train(c, "gpt")
    out = whole_state(c, main, scope)
    out.update(local_state(main, scope))
    out["losses"] = np.array(losses)
    return out, {}


def _sc_opt(opt):
    def sc(c):
        """BERT-tiny under ``opt`` at dp 2 x tp 2, 3 steps: the gathered
        state, the losses and the ops the rewrite made."""
        main, prog, exe, scope, losses, _ = train(c, "bert", opt=opt)
        out = whole_state(c, main, scope)
        out["losses"] = np.array(losses)
        ops = prog.program.global_block().ops
        types = [o.type for o in ops]
        return out, {"report": prog.program._tp_report,
                     "barriers": types.count("recompute_barrier"),
                     "norm_axes": [o.attrs.get("norm_axis") for o in ops
                                   if o.type in ("lamb", "lars_momentum")]}
    return sc


sc_recompute, sc_lamb, sc_lars = (_sc_opt(o) for o in
                                  ("recompute", "lamb", "lars"))


def sc_dropout(c):
    main, prog, exe, scope, losses, _ = train(c, "bert", steps=2,
                                              dropout=0.1)
    out = local_state(main, scope)
    out["losses"] = np.array(losses)
    return out, {}


def sc_ckpt(c):
    """4 steps straight, against 2 steps, a save, a load into a fresh
    scope and 2 more (dropout on: the run seed travels too)."""
    fluid = c.fluid
    main, startup, loss = c.program(build_bert, c.bert, BERT["B"] // 2,
                                    dropout=0.1)
    feeds = bert_feeds(c.bert, 4, seed=80)
    prog = c.compiled(main, loss)

    def steps(exe, scope, fs):
        return [np.array(exe.run(prog, feed=bert_rows(f, c.dp, 2),
                                 fetch_list=[loss], scope=scope)[0])
                for f in fs]

    exe, scope = c.scope(startup, "bert")
    base = steps(exe, scope, feeds)
    base_state = whole_state(c, main, scope)
    exe, scope = c.scope(startup, "bert")
    steps(exe, scope, feeds[:2])
    saved = whole_state(c, main, scope)
    ckpt = os.path.join(c.args["out"], "tp_ckpt")
    fluid.io.save_persistables(exe, ckpt, main_program=main, scope=scope)
    fresh = fluid.Scope()
    exe2 = fluid.Executor(c.place)
    exe2.run(startup, scope=fresh)
    fluid.io.load_persistables(exe2, ckpt, main_program=main, scope=fresh)
    resumed = steps(exe2, fresh, feeds[2:])
    out = {"saved/" + k: v for k, v in saved.items()}
    state = whole_state(c, main, fresh)
    same = all(np.array_equal(a, b) for a, b in zip(resumed, base[2:]))
    same_state = all(np.array_equal(state[k], base_state[k])
                     for k in base_state)
    return out, {"resume_bitwise": bool(same),
                 "state_bitwise": bool(same_state), "dir": ckpt}


GEN = {"max_len": 48, "bucket_min": 8, "lens": [11, 7], "new": 8}


def gen_prompts(vocab, seed=3):
    rng = np.random.default_rng(seed)
    return [rng.integers(1, vocab, n).astype(np.int32) for n in GEN["lens"]]


def sc_generate(c):
    """``GPTGenerator(tp=2)`` greedy, dense and paged, beside tp=1; then
    the typed errors of tp generation."""
    import pytest
    from paddle_tpu_torch.models import GPTConfig
    from paddle_tpu_torch.models.generation import (GPTGenerator,
                                                    TPCompileGateError)
    from paddle_tpu_torch.serving.engine import GenerationEngine
    cfg = GPTConfig.tiny()
    params = c.start("gpt_gen")
    prompts = gen_prompts(cfg.vocab_size)
    kw = dict(max_len=GEN["max_len"], bucket_min=GEN["bucket_min"],
              device="cpu")
    out = {}
    for tp in (1, 2):
        gen = GPTGenerator(cfg, params, tp=tp, **kw)
        for paged in (False, True):
            toks = gen.generate(prompts, max_new_tokens=GEN["new"], seed=0,
                                paged=paged)
            for i, t in enumerate(toks):
                out[f"tp{tp}/{'paged' if paged else 'dense'}/{i}"] = t
    gen = GPTGenerator(cfg, params, tp=2, **kw)
    flags = {"heads": gen.model.heads,
             "qkv": list(gen.model.param("decoder_layer_0_qkv.w_0").shape),
             "pool_heads": gen._pool(2, "fp32").num_heads}
    with pytest.raises(ValueError, match="divide num_heads"):
        GPTGenerator(cfg, params, tp=3, **kw)
    # the serving world is one tp group: a tp 2 engine in this world of
    # 4 would be replicas behind a router
    with pytest.raises(NotImplementedError, match="item 8b"):
        GenerationEngine(gen)
    c.fluid.set_flags({"FLAGS_shard_audit_replicated_mb": 0.001})
    real = c.gpt.tp_layouts
    try:
        c.gpt.tp_layouts = lambda cfg: {}       # a split of nothing
        bad = GPTGenerator(cfg, params, tp=2, **kw)
        with pytest.raises(TPCompileGateError, match="replicated large"):
            bad.generate(prompts[:1], max_new_tokens=2, seed=0,
                         paged=False)
    finally:
        c.gpt.tp_layouts = real
        c.fluid.set_flags({"FLAGS_shard_audit_replicated_mb": 16.0})
    flags["errors"] = True
    return out, flags


def sc_dp_after_tp(c):
    """A ``GPTGenerator(tp=2)``, then BERT-tiny made data-parallel over
    every rank, with no mesh given (``with_data_parallel()``) and with
    ``mesh=default_mesh()``: 2 steps each on each rank's row of the
    global batch; then the generator again. Each rank also runs the
    plain program on the whole batch."""
    from paddle_tpu_torch.models import GPTConfig
    from paddle_tpu_torch.models.generation import GPTGenerator
    cfg = GPTConfig.tiny()
    prompts = gen_prompts(cfg.vocab_size)
    gen = GPTGenerator(cfg, c.start("gpt_gen"), tp=2,
                       max_len=GEN["max_len"],
                       bucket_min=GEN["bucket_min"], device="cpu")

    def tokens():
        return gen.generate(prompts, max_new_tokens=GEN["new"], seed=0,
                            paged=True)
    before = tokens()
    n = c.mesh.world_size()
    feeds = bert_feeds(c.bert, 2)
    pmain, pstart, ploss = c.program(build_bert, c.bert, BERT["B"],
                                     tp=False)
    pexe, pscope = c.scope(pstart, "bert")
    plain = [float(np.ravel(pexe.run(pmain, feed=f, fetch_list=[ploss],
                                     scope=pscope)[0])[0]) for f in feeds]
    out = {"plain_losses": np.array(plain)}
    for p in pmain.all_parameters():
        out["plain/" + p.name] = np.array(pscope.find_var(p.name).numpy())
    flags = {}
    for kind, grid in (("none", None), ("default", c.mesh.default_mesh())):
        main, startup, loss = c.program(build_bert, c.bert, BERT["B"] // n,
                                        tp=False)
        exe, scope = c.scope(startup, "bert")
        prog = c.fluid.CompiledProgram(main).with_data_parallel(
            loss_name=loss.name, mesh=grid)
        out[f"{kind}/losses"] = np.array([float(np.ravel(exe.run(
            prog, feed=bert_rows(f, c.rank, n), fetch_list=[loss],
            scope=scope)[0])[0]) for f in feeds])
        for p in main.all_parameters():
            out[f"{kind}/" + p.name] = np.array(
                scope.find_var(p.name).numpy())
        flags[kind] = {"dp": prog.mesh.dp, "tp": prog.mesh.tp,
                       "step_ranks": sorted({s.rank for s in
                                             exe._steps.values()
                                             if s.data_parallel})}
    after = tokens()
    flags["tokens_same"] = all(np.array_equal(a, b)
                               for a, b in zip(before, after))
    return out, flags


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
    c.mesh.barrier()


if __name__ == "__main__":
    main(sys.argv[1])
