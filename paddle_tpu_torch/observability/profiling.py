"""Performance attribution: the per-op cost profiler and the HBM
live-set memory profiler.

Counterpart of ``paddle_tpu/observability/profiling.py``:

- :func:`profile_program`: the **estimated** per-op cost breakdown. It
  walks the (optionally pass-optimized clone of the) program's global
  block, attributes FLOPs and bytes per op from the declared shapes and
  ranks the ops by roofline-limited time against the same peak tables
  the live ``utilization`` gauges read. The executor's live gauges take
  their step cost from this estimate (:func:`program_cost`), so the
  gauge and the table agree by construction. Every op's rule is the JAX
  package's but the attention ops', which take the counts of the
  kernels that run them (:func:`_attention_flops`, :func:`_paged_bytes`;
  the JAX estimator has no rule for them and counts one FLOP per output
  element).
- **measured** mode (``FLAGS_profile_ops``, or ``measured=True``):
  :func:`measure_op_times` runs the optimized program op by op once
  more, on copies, synchronizing the device after each op, so each op's
  time lands in a per-op table and as ``op/<type>#<i>`` child spans of
  one ``profile/ops_<tag>`` span. ``Executor.run`` samples it every N-th
  run under ``FLAGS_profile_ops=N``; the step itself is untouched.
- :func:`memory_profile`: the HBM live-set profiler (persistables as
  the resident baseline, temporaries live from their definition to their
  last use, fetches to the end): peak bytes, the op index at the peak
  and the tensors live there; in measured mode a ``hbm_live_bytes``
  counter track beside the op spans.

``FLAGS_profile_ops=0`` (the default) costs the executor one flag read.
"""
import threading
import time

import numpy as np

from .. import profiler as _prof
from ..flags import flag as _flag
from . import tracing as _tracing
from .metrics import default_registry
from .utilization import hbm_peak, peak_flops

# peaks used for RANKING when the local device's are unknown (the CPU):
# the H100 SXM's dense bf16 rate and HBM3 bandwidth. The ordering of
# roofline-limited times is what matters offline, not absolute ms
REF_PEAK_FLOPS = 989e12
REF_HBM_PEAK = 3.35e12

_REPLAYS = default_registry().counter(
    "profile_op_replays_total",
    "measured op-granular profile replays recorded "
    "(FLAGS_profile_ops sampling)")
_REPLAY_MS = default_registry().counter(
    "profile_op_ms_total",
    "wall ms spent inside measured op-granular profile replays")

_last = {"measured": None}
_last_lock = threading.Lock()


# ---------------------------------------------------------------------------
# Shape resolution + per-op flop/byte estimation.
# ---------------------------------------------------------------------------

def _shape_table(program, feed=None, batch=None):
    """name -> concrete shape tuple for every var the global block
    declares. Feed arrays pin their own shapes; remaining -1 dims take
    ``batch`` (default: the leading dim of any fed array, else 1)."""
    block = program.global_block()
    shapes = {}
    if feed:
        for n, a in feed.items():
            shp = tuple(a) if isinstance(a, (tuple, list)) \
                else tuple(np.shape(a))
            shapes[n] = shp
            if batch is None and shp:
                batch = int(shp[0])
    if batch is None:
        batch = 1
    for n, v in block.vars.items():
        if n in shapes:
            continue
        shp = getattr(v, "shape", None)
        if shp is None:
            continue
        shapes[n] = tuple(int(batch) if int(d) == -1 else int(d)
                          for d in shp)
    return shapes


def _var_bytes(program, shapes, name, _memo):
    b = _memo.get(name)
    if b is not None:
        return b
    from ..framework.dtype import itemsize as _itemsize
    shp = shapes.get(name)
    b = 0
    if shp is not None:
        try:
            var = program.global_block().var(name)
            b = int(np.prod(shp, dtype=np.int64)) * _itemsize(var.dtype)
        except (ValueError, TypeError, KeyError):
            b = 0
    _memo[name] = b
    return b


def _prod(shp):
    return int(np.prod(shp, dtype=np.int64)) if shp else 1


# the attention ops: counted as the kernel table counts the kernels
# that run them (K1 forward, K2 backward, K5 paged decode)
_ATTENTION_OPS = ("flash_attention", "paged_attention")


def _causal(op):
    fwd = op.attrs.get("__fwd_op__") or {}
    return bool(op.attrs.get("causal",
                             (fwd.get("attrs") or {}).get("causal", False)))


def _attention_flops(op, t, shapes):
    """(flops, "attention"): ``flash_attention`` 4·B·H·Sq·Sk·D, its grad
    K2's five products, 10·B·H·Sq·Sk·D, each halved when causal;
    ``paged_attention`` 4·B·H·S·D over every position its block tables
    reach (nblk·bs)."""
    def first(slot):
        names = op.inputs.get(slot) or ()
        return shapes.get(names[0]) if names else None

    q, k = first("Q"), first("K")
    if not q or not k or len(q) != 4:
        return 0.0, "attention"
    B, H, Sq, D = (int(d) for d in q)
    if op.type == "paged_attention":
        tables = first("Tables")
        keys = int(tables[-1]) * int(k[2]) if tables else 0
        return 4.0 * B * H * Sq * keys * D, "attention"
    Sk = int(k[2])
    per = 10.0 if t.endswith("_grad") else 4.0
    flops = per * B * H * Sq * Sk * D
    return (flops / 2.0 if _causal(op) else flops), "attention"


def _paged_bytes(program, op, shapes, memo):
    """K5's bytes: the K and V vectors (and int8 scales) at every
    position the block tables reach, the query, the output, the tables
    and the positions."""
    from ..framework.dtype import itemsize as _itemsize

    def first(slot, outs=False):
        names = (op.outputs if outs else op.inputs).get(slot) or ()
        return names[0] if names else None

    tables = shapes.get(first("Tables"))
    kname = first("K")
    if not tables or kname is None or kname not in shapes:
        return 0
    kv = shapes[kname]                     # [N, H, bs, D]
    pos = int(tables[0]) * int(tables[-1]) * int(kv[2])
    block = program.global_block()
    total = 2 * pos * int(kv[1]) * int(kv[3]) * _itemsize(
        block.var(kname).dtype)
    if first("KScale") is not None:
        total += 2 * pos * int(kv[1]) * 4
    for n in (first("Q"), first("Tables"), first("Pos"),
              first("Out", outs=True)):
        if n is not None:
            total += _var_bytes(program, shapes, n, memo)
    return total


def _pin_paged_pools(program, shapes):
    """A decode cache write's output pool is declared with -1 block
    dims, which the batch size would fill: give it the shape of the pool
    it rewrites (the fed one), so the attention reading it is counted at
    the real block size."""
    for op in program.global_block().ops:
        if op.type != "paged_kv_cache_write":
            continue
        for src, dst in (("Cache", "Out"), ("Scale", "OutScale")):
            i, o = op.inputs.get(src) or (), op.outputs.get(dst) or ()
            if i and o and i[0] in shapes:
                shapes[o[0]] = shapes[i[0]]
    return shapes


def program_cost(program, feed_shapes):
    """``{"flops", "bytes"}`` of one run of ``program`` (already through
    the pass pipeline) at ``feed_shapes`` (``{name: shape}``): the
    estimate :func:`profile_program` ranks, summed. The executor's and
    the serving engine's live gauges read it, memoized per program
    version and feed signature."""
    shapes = _pin_paged_pools(program,
                              _shape_table(program, feed=feed_shapes))
    memo = {}
    flops = nbytes = 0.0
    for op in program.global_block().ops:
        flops += _op_flops(op, shapes)[0]
        nbytes += _op_bytes(program, op, shapes, memo)
    return {"flops": flops, "bytes": nbytes}



# op types with a specific flop rule ("named" attribution — everything
# else falls into the default one-flop-per-output-element bucket)
_MATMUL_OPS = ("mul", "matmul")

# per-param-element flop counts of the optimizer update kernels (moment
# updates + bias correction + the parameter write)
_OPT_FLOPS_PER_ELEM = {"sgd": 2.0, "momentum": 4.0, "adam": 12.0,
                       "adamw": 14.0}


def _op_flops(op, shapes):
    """(flops, rule): estimated FLOPs for one op plus the rule that
    produced them ("matmul"/"conv"/"gather"/"reduce"/"softmax"/
    "elementwise"/"attention"). Grad ops take 2x their forward's estimate
    (the generic vjp computes both input cotangents); the attention ops
    take their kernels' counts (:func:`_attention_flops`)."""
    t = op.type
    grad = t.endswith("_grad")
    base = t[:-5] if grad else t
    if base.startswith("fused_"):
        base = base[6:]
    mult = 2.0 if grad else 1.0

    def shp(slot, i=0):
        names = op.inputs.get(slot) or ()
        if i < len(names):
            return shapes.get(names[i])
        return None

    def out_shp(slot="Out", i=0):
        names = op.outputs.get(slot) or ()
        if i < len(names):
            return shapes.get(names[i])
        return None

    if base in _MATMUL_OPS:
        x = shp("X")
        y = shp("Y")
        out = out_shp()
        if x and out:
            if base == "mul":
                ncd = int(op.attrs.get("x_num_col_dims", 1))
                k = _prod(x[ncd:])
            else:
                k = int(x[-2] if op.attrs.get("transpose_X") else x[-1])
            return mult * 2.0 * _prod(out) * k, "matmul"
        if x and y:
            return mult * 2.0 * _prod(x) * (y[-1] if y else 1), "matmul"
    elif base in ("conv2d", "depthwise_conv2d"):
        out = out_shp("Output") or out_shp()
        flt = shp("Filter")
        if out and flt:
            per_out = 2.0 * _prod(flt[1:])     # Ci/groups * kh * kw MACs
            return mult * _prod(out) * per_out, "conv"
    elif base in ("lookup_table", "lookup_table_v2"):
        if grad:
            # backward is a scatter-ADD into the table: one add per
            # incoming grad element
            g = shp("Out@GRAD")
            return float(_prod(g)) if g else 0.0, "gather"
        return 0.0, "gather"                   # forward: pure movement
    elif base in _OPT_FLOPS_PER_ELEM and not grad:
        n = sum(_prod(shapes[nm]) for nm in op.inputs.get("Param", ())
                if nm in shapes)
        if n:
            return _OPT_FLOPS_PER_ELEM[base] * n, "optimizer"
    elif base in ("softmax", "softmax_with_cross_entropy"):
        x = shp("X") or shp("Logits")
        if x:
            return mult * 5.0 * _prod(x), "softmax"
    elif base in ("reduce_sum", "reduce_mean", "mean", "sum"):
        x = shp("X")
        if x:
            return mult * _prod(x), "reduce"
    elif base == "layer_norm":
        x = shp("X")
        if x:
            return mult * 8.0 * _prod(x), "reduce"
    elif base in _ATTENTION_OPS:
        return _attention_flops(op, t, shapes)
    # default: one flop per output element
    total = 0
    for names in op.outputs.values():
        for n in names:
            s = shapes.get(n)
            if s is not None:
                total += _prod(s)
    return mult * float(total), "elementwise"


def _op_bytes(program, op, shapes, memo):
    """HBM traffic estimate: every distinct input read once + every
    output written once (a fused kernel can do better: this is the
    attribution upper bound). ``paged_attention`` counts K5's bytes
    (:func:`_paged_bytes`), not its whole pools."""
    if op.type == "paged_attention":
        return _paged_bytes(program, op, shapes, memo)
    seen = set()
    total = 0
    for names in op.inputs.values():
        for n in names:
            if n not in seen:
                seen.add(n)
                total += _var_bytes(program, shapes, n, memo)
    for names in op.outputs.values():
        for n in names:
            if n not in seen:
                seen.add(n)
                total += _var_bytes(program, shapes, n, memo)
    return total


def profile_program(program, feed=None, fetch_list=None, scope=None,
                    batch=None, topk=None, cost=None, optimize=True,
                    measured=None):
    """Per-op cost attribution for ``program``'s global block.

    Returns a report dict:

    - ``ops``: one row per op, RANKED by roofline-limited time —
      ``{"index", "type", "outputs", "flops", "bytes", "est_ms",
      "bound", "rule", "share"}`` (``share`` = fraction of the total
      estimated time; ``bound`` = "compute"/"bandwidth").
    - ``totals``: summed ``flops``/``bytes``/``est_ms`` plus the peak
      table used.
    - ``coverage`` (when ``cost``, another ``{"flops", "bytes"}`` count
      of the same step, is given): ``est_vs_xla_flops_ratio`` /
      ``est_vs_xla_bytes_ratio`` (the JAX package's key names).
    - ``named_share``: fraction of estimated flops/bytes attributed by
      a SPECIFIC rule (matmul/conv/gather/reduce/softmax) rather than
      the default elementwise bucket.
    - ``measured`` (measured mode): the per-op time table from one
      synced interpretation on copies (see :func:`measure_op_times`).

    ``optimize=True`` profiles the pass pipeline's optimized CLONE (what
    the executor runs; the user program is never mutated); pass False to
    profile the program as written. ``measured`` defaults to
    ``bool(FLAGS_profile_ops)``.
    """
    from ..framework.passes import optimize_program
    fetch_names = []
    for f in (fetch_list or ()):
        fetch_names.append(getattr(f, "name", None) or str(f))
    prog = optimize_program(program, fetch_names=tuple(fetch_names)) \
        if optimize else program
    shapes = _pin_paged_pools(prog, _shape_table(prog, feed=feed,
                                                 batch=batch))
    pf = peak_flops() or REF_PEAK_FLOPS
    pb = hbm_peak() or REF_HBM_PEAK
    memo = {}
    rows = []
    tot_f = tot_b = tot_t = 0.0
    named_f = named_b = 0.0
    for i, op in enumerate(prog.global_block().ops):
        flops, rule = _op_flops(op, shapes)
        nbytes = _op_bytes(prog, op, shapes, memo)
        t_c = flops / pf
        t_m = nbytes / pb
        est_s = max(t_c, t_m)
        rows.append({
            "index": i, "type": op.type,
            "outputs": list(op.output_arg_names)[:4],
            "flops": flops, "bytes": nbytes,
            "est_ms": est_s * 1e3,
            "bound": "compute" if t_c >= t_m else "bandwidth",
            "rule": rule,
        })
        tot_f += flops
        tot_b += nbytes
        tot_t += est_s
        if rule != "elementwise":
            named_f += flops
            named_b += nbytes
    rows.sort(key=lambda r: -r["est_ms"])
    for r in rows:
        r["share"] = (r["est_ms"] / (tot_t * 1e3)) if tot_t else 0.0
    report = {
        "n_ops": len(rows),
        "ops": rows[:topk] if topk else rows,
        "totals": {"flops": tot_f, "bytes": tot_b,
                   "est_ms": tot_t * 1e3,
                   "peak_flops": pf, "peak_hbm_bytes_per_s": pb},
        "named_share": {
            "flops": (named_f / tot_f) if tot_f else 0.0,
            "bytes": (named_b / tot_b) if tot_b else 0.0,
        },
    }
    if cost:
        report["coverage"] = {
            "est_vs_xla_flops_ratio": (tot_f / cost["flops"])
            if cost.get("flops") else None,
            "est_vs_xla_bytes_ratio": (tot_b / cost["bytes"])
            if cost.get("bytes") else None,
        }
    if measured is None:
        measured = bool(_flag("profile_ops"))
    if measured:
        if scope is None:
            from ..framework.executor import global_scope
            scope = global_scope()
        env = {n: v for n, v in scope.items()}
        for n, a in (feed or {}).items():
            env[n] = np.asarray(a) if not hasattr(a, "dtype") else a
        report["measured"] = measure_op_times(prog, env,
                                              tag=str(program._uid))
    return report


def format_table(report, topk=12):
    """passes.stats()-style text table of the top-k rows."""
    lines = [f"{'#':>4} {'op':<28} {'GFLOP':>10} {'MiB':>9} "
             f"{'est_ms':>8} {'share':>6}  bound"]
    for r in report["ops"][:topk]:
        lines.append(
            f"{r['index']:>4} {r['type'][:28]:<28} "
            f"{r['flops'] / 1e9:>10.3f} {r['bytes'] / 2**20:>9.2f} "
            f"{r['est_ms']:>8.3f} {r['share'] * 100:>5.1f}%  "
            f"{r['bound']}")
    t = report["totals"]
    lines.append(f"{'':>4} {'TOTAL (' + str(report['n_ops']) + ' ops)':<28} "
                 f"{t['flops'] / 1e9:>10.3f} {t['bytes'] / 2**20:>9.2f} "
                 f"{t['est_ms']:>8.3f}")
    return "\n".join(lines)


# ---------------------------------------------------------------------------
# HBM live-set memory profiler (liveness + shapes -> byte timeline).
# ---------------------------------------------------------------------------

def memory_profile(program, fetch_names=(), feed=None, batch=None,
                   topk=8, optimize=False):
    """Byte-weighted live-set timeline over the global block.

    Persistable vars (params, optimizer state) are the resident
    baseline — live across the whole program. A temporary is live from
    the op that defines it through its last read (def-use chains,
    framework/analysis.py); fed vars are live from op 0; fetch targets
    stay live to the end. Returns::

        {"peak_bytes", "peak_op_index", "peak_op_type",
         "baseline_bytes", "timeline": [bytes per op index],
         "top": [{"name", "bytes", "producer", "kind"}, ...],  # at peak
         "n_ops"}
    """
    from ..framework.passes import optimize_program
    if isinstance(fetch_names, str):
        fetch_names = (fetch_names,)
    prog = optimize_program(program, fetch_names=tuple(fetch_names)) \
        if optimize else program
    block = prog.global_block()
    ops = block.ops
    n = len(ops)
    shapes = _shape_table(prog, feed=feed, batch=batch)
    memo = {}

    persist = set()
    for name, v in block.vars.items():
        if getattr(v, "persistable", False):
            persist.add(name)
    baseline = sum(_var_bytes(prog, shapes, p, memo) for p in persist)

    first_def, last_use, producer = {}, {}, {}
    for i, op in enumerate(ops):
        for nm in op.input_arg_names:
            if nm in persist:
                continue
            last_use[nm] = i
            first_def.setdefault(nm, 0)        # fed/scope state: live at 0
        for nm in op.output_arg_names:
            if nm in persist:
                continue
            first_def.setdefault(nm, i)
            last_use[nm] = max(last_use.get(nm, i), i)
            producer.setdefault(nm, op.type)
    for nm in fetch_names:
        if nm in first_def:
            last_use[nm] = n - 1

    # sweep: +bytes at first_def, -bytes after last_use
    delta = [0] * (n + 1)
    for nm, d0 in first_def.items():
        b = _var_bytes(prog, shapes, nm, memo)
        if not b:
            continue
        delta[d0] += b
        delta[last_use.get(nm, d0) + 1] -= b
    timeline = []
    cur = baseline
    peak, peak_idx = baseline, 0
    for i in range(n):
        cur += delta[i]
        timeline.append(cur)
        if cur > peak:
            peak, peak_idx = cur, i
    top = []
    for nm, d0 in first_def.items():
        if d0 <= peak_idx <= last_use.get(nm, d0):
            b = _var_bytes(prog, shapes, nm, memo)
            if b:
                top.append({"name": nm, "bytes": b,
                            "producer": producer.get(nm, "feed"),
                            "kind": "temp"})
    for p in persist:
        b = _var_bytes(prog, shapes, p, memo)
        if b:
            top.append({"name": p, "bytes": b, "producer": "persistable",
                        "kind": "param"})
    top.sort(key=lambda r: -r["bytes"])
    return {
        "peak_bytes": int(peak),
        "peak_op_index": int(peak_idx),
        "peak_op_type": ops[peak_idx].type if n else None,
        "baseline_bytes": int(baseline),
        "timeline": timeline,
        "top": top[:topk],
        "n_ops": n,
    }


# ---------------------------------------------------------------------------
# Measured mode: a synced op-by-op run on copies, with spans + the
# hbm_live_bytes counter track.
# ---------------------------------------------------------------------------

def _replay_safe(program):
    """Only pure programs replay: a measured replay EXECUTES every op a
    second time, and a side-effecting op (print, py_func, a collective)
    must never run twice for telemetry."""
    from ..framework.analysis import is_side_effect_type
    for blk in program.blocks:
        for op in blk.ops:
            if is_side_effect_type(op.type):
                return False
    return True


def _written_names(program):
    return {n for blk in program.blocks for op in blk.ops
            for n in op.output_arg_names}


def _env_tensors(program, env, device):
    """The replay's env: every value as a tensor on ``device`` (numpy
    feeds in their vars' dtypes), and a copy of each one an op writes,
    so ops that write in place (the optimizer updates, the decode cache
    writes) leave the caller's tensors as they were."""
    import torch
    from ..framework.dtype import torch_dtype
    block = program.global_block()
    written = _written_names(program)
    out = {}
    for n, v in env.items():
        if n == "@RNG_SEED@":
            continue
        if not isinstance(v, torch.Tensor):
            var = block.vars.get(n)
            t = torch.from_numpy(np.ascontiguousarray(v))
            v = t.to(device=device, dtype=torch_dtype(var.dtype)
                     if var is not None else t.dtype)
        elif n in written:
            v = v.clone()
        out[n] = v
    return out


def _env_device(env):
    import torch
    for v in env.values():
        if isinstance(v, torch.Tensor):
            return v.device
    return torch.device("cpu")


def measure_op_times(program, env, tag="program", mem=None,
                     allow_side_effects=False, sync=True, device=None,
                     run_seed=None):
    """Run the global block op by op over ``env`` (a plain dict of the
    caller's scope state and feeds; never written: values an op writes
    are copied first, feeds are converted), timing each op with the
    device synchronized after it (``sync``). The run seed is ``run_seed``
    (default: ``env["@RNG_SEED@"]``, else the program's), used and not
    advanced, so stochastic ops draw what the caller's run of the same
    step draws. Emits:

    - ``op/<type>#<i>`` spans as children of one ``profile/ops_<tag>``
      parent (under the ambient trace context when one is active),
      always recorded (traced spans bypass the profiler-active gate);
    - a ``hbm_live_bytes`` counter sample per op (the live-set estimate
      of :func:`memory_profile`, with -1 batch dims resolved from the
      fed values) while the profiler is active;
    - a row table, also kept for :func:`last_op_profile`.

    Returns ``{"tag", "rows", "total_ms", "n_ops", "peak_bytes",
    "peak_op_index"}``, or ``None`` when the program is not replay-safe
    (side-effecting ops present), unless ``allow_side_effects`` (the
    explicit ``profiler.profile_program`` path, where this walk IS the
    one execution)."""
    if not allow_side_effects and not _replay_safe(program):
        return None
    import torch
    from ..framework.lowering import LowerCtx, last_uses, run_op
    device = torch.device(device) if device is not None \
        else _env_device(env)
    if mem is None:
        feed_shapes = {
            n: tuple(np.shape(env[n]))
            for n, v in program.global_block().vars.items()
            if getattr(v, "is_data", False) and n in env}
        mem = memory_profile(program, feed=feed_shapes or None)
    timeline = mem["timeline"]
    block = program.global_block()
    if run_seed is None:
        run_seed = env.get("@RNG_SEED@")
        if run_seed is None:
            run_seed = int(program.random_seed or 0)
    ctx = LowerCtx(program, block, _env_tensors(program, env, device),
                   device, run_seed=int(run_seed))
    free = last_uses(block, set())
    cuda = device.type == "cuda"
    parent = _tracing.current() or _tracing.new_trace()
    rows = []
    t_begin = time.perf_counter()
    with torch.no_grad(), _tracing.ambient(parent):
        with _tracing.span(f"profile/ops_{tag}") as span_ctx:
            if sync and cuda:
                torch.cuda.synchronize(device)
            for i, op in enumerate(block.ops):
                t0 = time.perf_counter()
                run_op(ctx, op)
                if sync and cuda:
                    torch.cuda.synchronize(device)
                t1 = time.perf_counter()
                for n in free.get(i, ()):
                    ctx.env.pop(n, None)
                _tracing.record_child(f"op/{op.type}#{i}", t0, t1,
                                      span_ctx)
                if i < len(timeline):
                    _prof.record_counter("hbm_live_bytes", t1,
                                         timeline[i])
                rows.append({"index": i, "type": op.type,
                             "ms": (t1 - t0) * 1e3})
    total_ms = (time.perf_counter() - t_begin) * 1e3
    out = {"tag": str(tag), "rows": rows, "total_ms": total_ms,
           "n_ops": len(rows),
           "peak_bytes": mem["peak_bytes"],
           "peak_op_index": mem["peak_op_index"]}
    with _last_lock:
        _last["measured"] = out
    _REPLAYS.inc()
    _REPLAY_MS.inc(total_ms)
    return out


def last_op_profile():
    """The most recent measured per-op table (None until a measured
    replay ran: ``FLAGS_profile_ops`` sampling in the executor or
    ``profile_program(measured=True)``)."""
    with _last_lock:
        return _last["measured"]
