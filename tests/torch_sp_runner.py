"""Worker of the port's sequence-parallel CPU tests
(``test_torch_sequence_parallel.py``): one rank of a gloo world of 4
started by ``python -m paddle_tpu_torch.distributed.launch
--nproc_per_node=4 --device=cpu``. Each scenario lays the world out on
the meshes it names: sp 4, dp 2 x sp 2 (ranks 0, 1 one sp group, 2, 3
the other) and tp 2 x sp 2 (ranks 0, 1 one tp group).

    python torch_sp_runner.py <args.json>

``args``: ``{"out": dir, "scenarios": [names], "start": {model: npz
path}}``. Each scenario writes ``<out>/<scenario>.<rank>.npz`` (its
arrays; ``__flags__`` holds a JSON of its booleans and numbers). The
builders take either package's ``fluid``, so the test builds the JAX
reference from the same function; the JAX package's startup values
reach the ranks through the ``start`` files. Every dp rank is fed its
rows of one global batch made here from a seed. This module imports
the port only (the ranks never import JAX).
"""
import json
import os
import sys

import numpy as np

# the op tests' shapes (tests/test_ring_attention.py)
B, H, S, D = 2, 4, 16, 8
BERT = {"B": 4, "S": 16, "P": 3, "steps": 3}
MECHS = (None, "flash", "ring", "ulysses")
GRIDS = {"sp4": {"sp": 4}, "dp2sp2": {"dp": 2, "sp": 2},
         "tp2sp2": {"tp": 2, "sp": 2}}
LONG_STEPS = 25


# ----------------------------------------------------------------- builds

def build_attention(fluid, mech, bias_shape=None, causal=False,
                    shape=(B, H, S, D), bias_grad=False):
    """q, k, v (and a bias) fed whole, ``layers.nn.ring_attention``, the
    grads of sum(out * out): (out, [gq, gk, gv (, gbias)])."""
    layers = fluid.layers
    q, k, v = (layers.data(n, list(shape), dtype="float32")
               for n in "qkv")
    for t in (q, k, v):
        t.stop_gradient = False
    bias = None
    if bias_shape is not None:
        bias = layers.data("bias", list(bias_shape), dtype="float32")
        bias.stop_gradient = not bias_grad
    out = layers.nn.ring_attention(q, k, v, attn_bias=bias, mechanism=mech,
                                   causal=causal)
    loss = layers.reduce_sum(layers.elementwise_mul(out, out))
    wrt = [q, k, v] + ([bias] if bias_grad else [])
    return out, fluid.gradients(loss, wrt)


def attention_feed(bias_kind=None, seed=0, shape=(B, H, S, D)):
    rng = np.random.default_rng(seed)
    feed = {n: rng.standard_normal(shape).astype(np.float32) for n in "qkv"}
    b, h, s, _ = shape
    if bias_kind == "key":
        # the padding mask of the JAX test: the last 4 keys masked
        bias = np.zeros((b, 1, 1, s), np.float32)
        bias[..., -4:] = -1e30
        feed["bias"] = bias
    elif bias_kind == "full":
        feed["bias"] = np.where(rng.uniform(size=(b, h, s, s)) < 0.15,
                                -1e30, 0.0).astype(np.float32)
    elif bias_kind == "causal":
        feed["bias"] = np.broadcast_to(np.triu(np.full(
            (s, s), -1e30, np.float32), k=1), (b, 1, s, s)).copy()
    elif bias_kind == "soft":
        # a finite key bias whose grad is read
        feed["bias"] = rng.standard_normal((b, 1, 1, s)).astype(np.float32)
    return feed


BIAS_SHAPES = {None: None, "key": (B, 1, 1, S), "full": (B, H, S, S),
               "causal": (B, 1, S, S), "soft": (B, 1, 1, S)}

# (name, mechanism, bias kind, causal, grid, bias grad)
OP_CASES = [(f"{m}_{b or 'none'}{'_causal' if c else ''}_{g}", m, b, c, g,
             bg)
            for m in ("ring", "ulysses")
            for b, c, g, bg in (("key", False, "sp4", False),
                                ("key", False, "dp2sp2", False),
                                ("full", False, "sp4", False),
                                ("causal", False, "sp4", False),
                                (None, True, "sp4", False),
                                (None, True, "dp2sp2", False),
                                ("soft", True, "sp4", True))]


def long_seq_model(fluid):
    """tests/test_ring_attention.py's toy long-context model: ring
    attention inside a trainable head, Adam at 0.01."""
    layers = fluid.layers
    T = fluid.layers
    x = layers.data("x", [B, S, H * D], dtype="float32")
    y = layers.data("y", [B, S, H * D], dtype="float32")
    qkv = layers.fc(x, 3 * H * D, num_flatten_dims=2)
    qkv = T.reshape(qkv, [B, S, 3, H, D])
    qkv = T.transpose(qkv, [2, 0, 3, 1, 4])
    q, k, v = (T.reshape(T.slice(qkv, axes=[0], starts=[i], ends=[i + 1]),
                         [B, H, S, D]) for i in range(3))
    att = layers.nn.ring_attention(q, k, v)
    merged = T.reshape(T.transpose(att, [0, 2, 1, 3]), [B, S, H * D])
    loss = layers.mean(layers.square_error_cost(
        layers.fc(merged, H * D, num_flatten_dims=2), y))
    fluid.optimizer.Adam(0.01).minimize(loss)
    return loss


def long_seq_feed():
    rng = np.random.default_rng(2)
    xv = rng.standard_normal((B, S, H * D)).astype(np.float32)
    return {"x": xv, "y": np.roll(xv, 1, axis=1).astype(np.float32)}


def bert_cfg(bert, mech, dropout=0.0):
    cfg = bert.BertConfig.tiny()
    cfg.hidden_dropout = cfg.attn_dropout = dropout
    cfg.attn_mechanism = mech
    return cfg


def build_bert(fluid, bert, rows, mech, sp_shard=True, tp=False,
               dropout=0.0, recompute=False, causal=False):
    """BERT-tiny pretraining at ``rows`` sequences, the hidden state
    pinned to ("dp", "sp", None), Adam at 1e-3 (under
    ``RecomputeOptimizer`` with the layer checkpoints with
    ``recompute``); ``causal`` sets ``causal=True`` on every
    ``flash_attention`` op."""
    cfg = bert_cfg(bert, mech, dropout)
    out = bert.bert_pretrain(cfg, rows, BERT["S"], BERT["P"],
                             sp_shard=sp_shard)
    if tp:
        bert.apply_tp_sharding(out["loss"].block.program, cfg)
    if causal:
        for op in out["loss"].block.ops:
            if op.type == "flash_attention":
                op.attrs["causal"] = True
    opt = fluid.optimizer.AdamOptimizer(1e-3)
    if recompute:
        opt = fluid.optimizer.RecomputeOptimizer(opt)
        opt._set_checkpoints(out["checkpoints"])
    opt.minimize(out["loss"])
    return out["loss"]


def bert_feeds(bert, steps=BERT["steps"], seed=40):
    cfg = bert_cfg(bert, None)
    return [bert.random_batch(cfg, BERT["B"], BERT["S"], BERT["P"],
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


# ------------------------------------------------------------- scenarios

class Ctx:
    def __init__(self, args):
        import torch
        torch.set_num_threads(1)
        import paddle_tpu_torch as fluid
        from paddle_tpu_torch.models import bert
        from paddle_tpu_torch.parallel import mesh
        self.fluid, self.bert, self.mesh = fluid, bert, mesh
        self.args = args
        mesh.init_parallel_env()
        self.rank = mesh.rank()
        self.place = fluid.CPUPlace()

    def grid(self, name):
        return self.mesh.make_mesh(self.mesh.MeshConfig(**GRIDS[name]))

    def start(self, model):
        with np.load(self.args["start"][model]) as z:
            return {k: z[k] for k in z.files}

    def program(self, fn, *a, seed=7, **kw):
        fluid = self.fluid
        main, startup = fluid.Program(), fluid.Program()
        main.random_seed = startup.random_seed = seed
        with fluid.unique_name.guard(), fluid.program_guard(main, startup):
            got = fn(fluid, *a, **kw)
        return main, startup, got

    def scope(self, startup, model=None):
        from paddle_tpu_torch.framework.executor import scope_from_arrays
        exe = self.fluid.Executor(self.place)
        scope = self.fluid.Scope()
        exe.run(startup, scope=scope)
        if model is not None:
            scope_from_arrays(scope, self.start(model))
        return exe, scope


def _rows(arr, d, n):
    b = arr.shape[0] // n
    return arr[d * b:(d + 1) * b]


def sc_ops(c):
    """Each of ``OP_CASES``: out and the grads of whole q, k, v (and the
    bias) fetched from the sp program, fed the rank's dp rows; then the
    divisibility errors."""
    out = {}
    for name, mech, bias, causal, grid_name, bias_grad in OP_CASES:
        grid = c.grid(grid_name)
        d, n = grid.coords()["dp"], grid.dp
        bs = BIAS_SHAPES[bias]
        main, startup, (o, grads) = c.program(
            build_attention, mech, bs and (B // n,) + bs[1:], causal,
            shape=(B // n, H, S, D), bias_grad=bias_grad)
        exe, scope = c.scope(startup)
        prog = c.fluid.CompiledProgram(main).with_data_parallel(mesh=grid)
        feed = {k: _rows(v, d, n) for k, v in attention_feed(bias).items()}
        # the split op's own grads of its K/V chunk
        gop = next(op for op in prog.program.global_block().ops
                   if op.type == f"{mech}_attention_grad")
        local = [gop.output("K@GRAD")[0], gop.output("V@GRAD")[0]]
        vals = exe.run(prog, feed=feed,
                       fetch_list=[o] + list(grads) + local, scope=scope)
        for tag, v in zip(("dk_local", "dv_local"), vals[-2:]):
            out[f"{name}/{tag}"] = np.asarray(v)
        for tag, v in zip(("out", "gq", "gk", "gv", "gbias"), vals[:-2]):
            out[f"{name}/{tag}"] = np.asarray(v)
        if name == "ring_key_sp4":
            types = [op.type for op in prog.program.global_block().ops]
            out["ring_key_sp4/types"] = np.array(types)
    errors = {}
    grid = c.grid("sp4")
    for mech, shape in (("ring", (B, H, 18, D)), ("ulysses", (B, 6, S, D))):
        main, startup, (o, _) = c.program(build_attention, mech,
                                          shape=shape)
        try:
            c.fluid.CompiledProgram(main).with_data_parallel(mesh=grid)
            errors[mech] = ""
        except ValueError as e:
            errors[mech] = str(e)
    return out, {"errors": errors}


def sc_long_seq(c):
    grid = c.grid("sp4")
    main, startup, loss = c.program(long_seq_model, seed=1)
    exe, scope = c.scope(startup, "long_seq")
    prog = c.fluid.CompiledProgram(main).with_data_parallel(
        loss_name=loss.name, mesh=grid)
    feed = long_seq_feed()
    losses = [float(np.ravel(exe.run(prog, feed=feed, fetch_list=[loss],
                                     scope=scope)[0])[0])
              for _ in range(LONG_STEPS)]
    return {"losses": np.array(losses)}, {}


def _whole_params(c, main, scope):
    from paddle_tpu_torch.parallel.tp import gathered
    with gathered(scope):
        return {p.name: np.array(scope.find_var(p.name).numpy())
                for p in main.all_parameters()}


def _train_bert(c, mech, grid_name, dropout=0.0, steps=BERT["steps"],
                **kw):
    grid = c.grid(grid_name)
    d, n = grid.coords()["dp"], grid.dp
    main, startup, loss = c.program(
        build_bert, c.bert, BERT["B"] // n, mech, tp=grid.tp > 1,
        dropout=dropout, **kw)
    exe, scope = c.scope(startup, "bert")
    prog = c.fluid.CompiledProgram(main).with_data_parallel(
        loss_name=loss.name, mesh=grid)
    losses = [float(np.ravel(exe.run(prog, feed=bert_rows(f, d, n),
                                     fetch_list=[loss],
                                     scope=scope)[0])[0])
              for f in bert_feeds(c.bert, steps)]
    return main, prog, scope, losses


def _plain_bert(c, mech, dropout=0.0, steps=BERT["steps"], **kw):
    """The port's one-rank run of the whole batch (no mesh)."""
    main, startup, loss = c.program(build_bert, c.bert, BERT["B"], mech,
                                    dropout=dropout, **kw)
    exe, scope = c.scope(startup, "bert")
    losses = [float(np.ravel(exe.run(main, feed=f, fetch_list=[loss],
                                     scope=scope)[0])[0])
              for f in bert_feeds(c.bert, steps)]
    return _whole_params(c, main, scope), losses


def sc_bert(c):
    """BERT-tiny ``sp_shard`` under each mechanism on each grid, 3 Adam
    steps; rank 0 also runs the one-rank program of the whole batch."""
    out, flags = {}, {}
    for mech in MECHS:
        tag = mech or "none"
        for g in GRIDS:
            main, prog, scope, losses = _train_bert(c, mech, g)
            params = _whole_params(c, main, scope)
            for k, v in params.items():
                out[f"{tag}/{g}/{k}"] = v
            out[f"{tag}/{g}/losses"] = np.array(losses)
            flags[f"{tag}/{g}"] = {
                "report": getattr(prog.program, "_sp_report", {}),
                "coords": c.grid(g).coords()}
        if c.rank == 0:
            params, losses = _plain_bert(c, mech)
            for k, v in params.items():
                out[f"{tag}/plain/{k}"] = v
            out[f"{tag}/plain/losses"] = np.array(losses)
    return out, flags


# Queue 3's sp faults: (name, mechanism, build keywords), each at dp 2 x
# sp 2 against the JAX package's one-device run of the same program
FAULT_CASES = (("recompute_einsum", None, {"recompute": True}),
               ("recompute_flash", "flash", {"recompute": True}),
               ("causal_flash", "flash", {"causal": True}),
               ("causal_flash_recompute", "flash",
                {"causal": True, "recompute": True}))


def sc_faults(c):
    """Each of ``FAULT_CASES`` at dp 2 x sp 2, 3 Adam steps; rank 0 also
    runs the one-rank program of the whole batch."""
    out, flags = {}, {}
    for name, mech, kw in FAULT_CASES:
        if c.rank == 0:
            params, losses = _plain_bert(c, mech, **kw)
            for k, v in params.items():
                out[f"{name}/plain/{k}"] = v
        main, prog, scope, losses = _train_bert(c, mech, "dp2sp2", **kw)
        for k, v in _whole_params(c, main, scope).items():
            out[f"{name}/{k}"] = v
        out[f"{name}/losses"] = np.array(losses)
        ops = prog.program.global_block().ops
        types = [o.type for o in ops]
        flags[name] = {"coords": c.grid("dp2sp2").coords(),
                       "report": getattr(prog.program, "_sp_report", {}),
                       "barriers": types.count("recompute_barrier"),
                       "flash_q_gathered": [
                           o.input("Q")[0].split("@SP_")[-1].startswith(
                               "GATHER") for o in ops
                           if o.type == "flash_attention"]}
    return out, flags


def sc_dropout(c):
    """Dropout 0.1 at sp 4 (dp 1: every rank's dp fold is the run seed)
    against the one-rank run of the same rows."""
    out = {}
    main, prog, scope, losses = _train_bert(c, None, "sp4", dropout=0.1,
                                            steps=2)
    for k, v in _whole_params(c, main, scope).items():
        out[f"sp/{k}"] = v
    out["sp/losses"] = np.array(losses)
    params, plain = _plain_bert(c, None, dropout=0.1, steps=2)
    for k, v in params.items():
        out[f"plain/{k}"] = v
    out["plain/losses"] = np.array(plain)
    ops = prog.program.global_block().ops
    chunks = [op.attrs.get("sp_chunk") for op in ops
              if op.type == "dropout"]
    return out, {"chunks": [list(x) if x else None for x in chunks]}


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
