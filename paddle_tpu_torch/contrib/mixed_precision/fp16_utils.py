"""Program rewrite for mixed precision (a copy of
``paddle_tpu/contrib/mixed_precision/fp16_utils.py``).

The rewrite inserts explicit ``cast`` ops into the IR. Parameters stay
float32 in the scope (master weights) and are cast where they are used;
their grads come back float32, because the ``cast`` op's vjp casts the
cotangent up again. Run it BEFORE ``append_backward``, so the backward
inherits the mixed dtypes through the grads.
"""
from ...framework.core import Operator
from ...framework.dtype import convert_dtype, is_float_dtype

# Per-op-type slots holding persistent state that stays float32 while
# the op itself computes in the low-precision dtype.
_FP32_STATE_SLOTS = {
    "batch_norm": (
        {"Scale", "Bias", "Mean", "Variance"},
        {"MeanOut", "VarianceOut", "SavedMean", "SavedVariance"}),
    "sync_batch_norm": (
        {"Scale", "Bias", "Mean", "Variance"},
        {"MeanOut", "VarianceOut", "SavedMean", "SavedVariance"}),
}


def rewrite_program(main_program, amp_lists, dest_dtype="bfloat16"):
    """Insert casts so white-list ops (and gray ops fed by them) compute
    in ``dest_dtype`` while black-list ops stay float32. Mutates
    ``main_program``."""
    block = main_program.global_block()
    new_ops = []
    cast_cache = {}   # (var_name, dtype) -> cast var name
    cur_dtype = {}    # var name -> current runtime dtype string

    def dtype_of(name):
        if name in cur_dtype:
            return cur_dtype[name]
        return convert_dtype(block.var(name).dtype) \
            if block.has_var(name) else None

    def cast_to(name, dtype):
        """Get or create ``name`` cast to dtype; emits the cast op."""
        key = (name, dtype)
        if key in cast_cache:
            return cast_cache[key]
        cast_name = f"{name}.cast_{dtype}"
        src_var = block.var(name)
        block.create_var(name=cast_name, shape=src_var.shape, dtype=dtype,
                         stop_gradient=src_var.stop_gradient)
        new_ops.append(Operator(block, "cast", inputs={"X": [name]},
                                outputs={"Out": [cast_name]},
                                attrs={"in_dtype": dtype_of(name),
                                       "out_dtype": dtype}))
        cast_cache[key] = cast_name
        return cast_name

    for op in list(block.ops):
        kind = amp_lists.classify(op.type)
        if kind == "skip":
            new_ops.append(op)
            for n in op.output_arg_names:
                cur_dtype.pop(n, None)
            continue

        float_in_dtypes = [dtype_of(n) for n in op.input_arg_names
                           if dtype_of(n) in ("float32", dest_dtype)]
        if kind == "white":
            compute = dest_dtype
        elif kind == "black":
            compute = "float32"
        else:  # gray: follow producers
            compute = dest_dtype if dest_dtype in float_in_dtypes \
                else "float32"
        if any(n in amp_lists.black_varnames for n in op.input_arg_names):
            compute = "float32"

        state_in, state_out = _FP32_STATE_SLOTS.get(op.type,
                                                    (frozenset(),
                                                     frozenset()))
        changed = False
        new_inputs = {}
        for slot, names in op.inputs.items():
            if slot in state_in:
                new_inputs[slot] = list(names)   # float32 state: never cast
                continue
            renamed = []
            for n in names:
                d = dtype_of(n)
                if d in ("float32", dest_dtype) and d != compute:
                    renamed.append(cast_to(n, compute))
                    changed = True
                else:
                    renamed.append(n)
            new_inputs[slot] = renamed
        if changed:
            op.inputs = new_inputs

        new_ops.append(op)
        if compute == dest_dtype:
            for slot, names in op.outputs.items():
                if slot in state_out:
                    continue                     # float32 state
                for n in names:
                    if block.has_var(n) and \
                            is_float_dtype(block.var(n).dtype):
                        block.var(n).dtype = dest_dtype
                        cur_dtype[n] = dest_dtype
        else:
            for n in op.output_arg_names:
                cur_dtype.pop(n, None)

    block.ops = new_ops
    main_program._bump_version()
    return main_program
