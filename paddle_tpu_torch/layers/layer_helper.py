"""LayerHelper: the op-emitting workhorse behind every layer function (a
trimmed copy of ``paddle_tpu/layers/layer_helper.py``, static graph
only)."""
from ..framework import initializer as init_mod
from ..framework import unique_name
from ..framework.core import default_main_program
from ..param_attr import ParamAttr


class LayerHelper:
    def __init__(self, layer_type, **kwargs):
        self.kwargs = kwargs
        self.layer_type = layer_type
        self.name = kwargs.get("name") or unique_name.generate(layer_type)

    @property
    def main_program(self):
        return default_main_program()

    @property
    def block(self):
        return self.main_program.current_block()

    @property
    def param_attr(self):
        return ParamAttr._to_attr(self.kwargs.get("param_attr"))

    @property
    def bias_attr(self):
        return ParamAttr._to_attr(self.kwargs.get("bias_attr"))

    def create_variable_for_type_inference(self, dtype, stop_gradient=False):
        return self.block.create_var(
            name=unique_name.generate(f"{self.name}.tmp"), dtype=dtype,
            stop_gradient=stop_gradient)

    def create_parameter(self, attr, shape, dtype="float32", is_bias=False,
                         default_initializer=None):
        attr = ParamAttr._to_attr(attr)
        if attr is False:
            return None
        name = attr.name or unique_name.generate(
            f"{self.name}.b" if is_bias else f"{self.name}.w")
        initializer = attr.initializer or default_initializer
        if initializer is None:
            initializer = (init_mod._global_bias_initializer() if is_bias
                           else init_mod._global_weight_initializer())
        param = self.block.create_parameter(
            name=name, shape=shape, dtype=dtype,
            initializer=initializer, regularizer=attr.regularizer,
            trainable=attr.trainable,
            do_model_average=attr.do_model_average,
            need_clip=attr.need_clip,
            learning_rate=attr.learning_rate)
        initializer(param)
        return param

    def create_global_variable(self, shape, dtype, persistable=True,
                               name=None, stop_gradient=True,
                               initializer=None):
        gblock = self.main_program.global_block()
        name = name or unique_name.generate(f"{self.name}.global")
        var = gblock.create_var(name=name, shape=shape, dtype=dtype,
                                persistable=persistable,
                                stop_gradient=stop_gradient)
        if initializer is not None:
            initializer(var)
        return var

    def append_op(self, **kwargs):
        return self.block.append_op(**kwargs)

    def append_activation(self, out_var, act=None):
        act = act or self.kwargs.get("act")
        if act is None:
            return out_var
        if isinstance(act, str):
            act = {"type": act}
        act_type = act.pop("type")
        tmp = self.create_variable_for_type_inference(dtype=out_var.dtype)
        self.append_op(type=act_type, inputs={"X": [out_var]},
                       outputs={"Out": [tmp]}, attrs=act)
        return tmp

    def append_bias_op(self, input_var, dim_start=1, dim_end=None):
        bias_attr = self.bias_attr
        if bias_attr is False:
            return input_var
        size = list(input_var.shape[dim_start:dim_end])
        bias = self.create_parameter(bias_attr, shape=size,
                                     dtype=input_var.dtype, is_bias=True)
        tmp = self.create_variable_for_type_inference(dtype=input_var.dtype)
        self.append_op(type="elementwise_add",
                       inputs={"X": [input_var], "Y": [bias]},
                       outputs={"Out": [tmp]}, attrs={"axis": dim_start})
        return tmp
