"""LayerHelper: shared machinery for layer functions (ref
``python/paddle/fluid/layer_helper.py``): creates parameters in BOTH the main
program (as Parameter vars) and the startup program (with their init op),
appends ops, handles bias/activation epilogues. Name generation matches
``paddle_tpu`` call for call, so both packages name every var alike."""

from . import framework
from . import unique_name
from .framework import Parameter
from .initializer import ConstantInitializer, XavierInitializer
from .param_attr import ParamAttr

__all__ = ["LayerHelper"]


class LayerHelper:
    def __init__(self, layer_type, **kwargs):
        self.kwargs = kwargs
        self.layer_type = layer_type
        name = kwargs.get("name")
        self.name = name if name else unique_name.generate(layer_type)

    @property
    def main_program(self):
        return framework.default_main_program()

    @property
    def startup_program(self):
        return framework.default_startup_program()

    @property
    def param_attr(self):
        return ParamAttr._to_attr(self.kwargs.get("param_attr"))

    @property
    def bias_attr(self):
        return ParamAttr._to_attr(self.kwargs.get("bias_attr"))

    def create_parameter(self, attr, shape, dtype="float32", is_bias=False,
                         default_initializer=None):
        if attr is False:
            return None
        attr = ParamAttr._to_attr(attr)
        if attr.name is None:
            suffix = "b" if is_bias else "w"
            attr.name = unique_name.generate("%s.%s_0" % (self.name, suffix))
        init = attr.initializer or default_initializer
        if init is None:
            init = ConstantInitializer(0.0) if is_bias else XavierInitializer()

        main_block = self.main_program.global_block()
        # reusing a ParamAttr name shares the weight (fluid semantics)
        existing = main_block.vars.get(attr.name)
        if isinstance(existing, Parameter):
            if tuple(existing.shape) != tuple(shape):
                raise ValueError(
                    "parameter %r reused with shape %s but it exists with "
                    "shape %s" % (attr.name, shape, existing.shape))
            if existing.dtype != framework.convert_np_dtype(dtype):
                raise ValueError(
                    "parameter %r reused with dtype %s but it exists with "
                    "dtype %s" % (attr.name, dtype, existing.dtype))
            return existing
        param = main_block.create_parameter(shape=shape, dtype=dtype,
                                            **attr._to_kwargs())
        param.initializer = init

        # same-named var + init op in the startup program
        startup_block = self.startup_program.global_block()
        sp_var = startup_block.create_var(
            name=attr.name, shape=shape, dtype=dtype, persistable=True)
        init(sp_var, startup_block)
        return param

    def create_variable_for_type_inference(self, dtype="float32", shape=None,
                                           stop_gradient=False):
        return self.main_program.current_block().create_var(
            name=unique_name.generate(".".join([self.name, "tmp"])),
            shape=shape, dtype=dtype, persistable=False,
            stop_gradient=stop_gradient)

    def append_op(self, type, inputs=None, outputs=None, attrs=None):
        return self.main_program.current_block().append_op(
            type, inputs, outputs, attrs)

    def append_bias_op(self, input_var):
        bias_attr = self.bias_attr
        if bias_attr is False:
            return input_var
        size = input_var.shape[-1]
        b = self.create_parameter(bias_attr, shape=[size],
                                  dtype=str(input_var.dtype), is_bias=True)
        out = self.create_variable_for_type_inference(
            dtype=str(input_var.dtype), shape=input_var.shape)
        self.append_op("elementwise_add", {"X": input_var, "Y": b},
                       {"Out": out}, {"axis": len(input_var.shape) - 1})
        return out

    def append_activation(self, input_var):
        act = self.kwargs.get("act")
        if act is None:
            return input_var
        out = self.create_variable_for_type_inference(
            dtype=str(input_var.dtype), shape=input_var.shape)
        self.append_op(act, {"X": input_var}, {"Out": out}, {})
        return out
