"""Decoupled weight decay (a copy of
``paddle_tpu/contrib/extend_optimizer.py``): a class decorator giving
``<Base>WithDecoupledWeightDecay``, whose ``minimize`` snapshots each
parameter it optimizes (``assign`` ops ahead of the update ops) and
then applies ``p -= coeff * snapshot`` (``scale`` + ``elementwise_add``)
after the base optimizer's update."""

__all__ = ["extend_with_decoupled_weight_decay"]


def extend_with_decoupled_weight_decay(base_optimizer):
    from ..optimizer import Optimizer
    if not (isinstance(base_optimizer, type)
            and issubclass(base_optimizer, Optimizer)):
        raise TypeError(
            "extend_with_decoupled_weight_decay expects an Optimizer "
            "subclass")

    class OptimizerWithDecoupledWeightDecay(base_optimizer):
        def __init__(self, weight_decay, *args, **kwargs):
            super().__init__(*args, **kwargs)
            self._decoupled_coeff = float(weight_decay)

        def minimize(self, loss, startup_program=None,
                     parameter_list=None, no_grad_set=None):
            from ..framework import unique_name
            block = loss.block
            # snapshot params BEFORE the update ops are appended —
            # only the ones this minimize actually optimizes
            # (parameter_list / no_grad_set restrict the decay too)
            allowed = None
            if parameter_list is not None:
                allowed = {p if isinstance(p, str) else p.name
                           for p in parameter_list}
            excluded = {p if isinstance(p, str) else p.name
                        for p in (no_grad_set or ())}
            params = [v for v in block.vars.values()
                      if getattr(v, "is_parameter", False)
                      and getattr(v, "trainable", True)
                      and (allowed is None or v.name in allowed)
                      and v.name not in excluded]
            snaps = []
            for p in params:
                s = block.create_var(
                    name=unique_name.generate(p.name + "_wd_snap"),
                    shape=p.shape, dtype=p.dtype, stop_gradient=True)
                block.append_op(type="assign", inputs={"X": [p.name]},
                                outputs={"Out": [s.name]})
                snaps.append((p, s))
            result = super().minimize(
                loss, startup_program=startup_program,
                parameter_list=parameter_list, no_grad_set=no_grad_set)
            coeff = self._decoupled_coeff
            for p, s in snaps:
                # p -= coeff * snapshot
                scaled = block.create_var(
                    name=unique_name.generate(p.name + "_wd_term"),
                    shape=p.shape, dtype=p.dtype, stop_gradient=True)
                block.append_op(
                    type="scale", inputs={"X": [s.name]},
                    outputs={"Out": [scaled.name]},
                    attrs={"scale": -coeff})
                block.append_op(
                    type="elementwise_add",
                    inputs={"X": [p.name], "Y": [scaled.name]},
                    outputs={"Out": [p.name]})
            return result

    OptimizerWithDecoupledWeightDecay.__name__ = (
        base_optimizer.__name__ + "WithDecoupledWeightDecay")
    return OptimizerWithDecoupledWeightDecay
