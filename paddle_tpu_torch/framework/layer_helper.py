"""LayerHelper: shared plumbing for layer functions.

Port of ``paddle_tpu/framework/layer_helper.py``: creates parameters
(wiring their initializer ops into the startup program), temporary output
variables, and appends ops to the current main-program block; in dygraph
mode the same calls go to the tracer (eager parameters, placeholder
tensors that the tracer fills, ops run as they are appended).
"""
from __future__ import annotations

from typing import Optional

from . import initializer as init
from . import program as framework
from . import unique_name
from .param_attr import ParamAttr


class LayerHelper:
    def __init__(self, layer_type: str, **kwargs):
        self.kwargs = kwargs
        self.layer_type = layer_type
        name = kwargs.get("name")
        self.name = name or unique_name.generate(layer_type)

    @property
    def main_program(self) -> framework.Program:
        return framework.default_main_program()

    @property
    def startup_program(self) -> framework.Program:
        return framework.default_startup_program()

    def append_op(self, type, inputs=None, outputs=None, attrs=None):
        if framework.in_dygraph_mode():
            return framework._current_tracer().trace_op(
                type, inputs or {}, outputs or {}, attrs or {})
        return self.main_program.current_block().append_op(
            type, inputs=inputs, outputs=outputs, attrs=attrs)

    def create_parameter(self, attr, shape, dtype="float32",
                         is_bias: bool = False, default_initializer=None,
                         stop_gradient: bool = False):
        attr = ParamAttr._to_attr(attr)
        if attr is False:
            return None
        if default_initializer is None:
            if is_bias:
                default_initializer = (init.global_bias_initializer()
                                       or init.ConstantInitializer(0.0))
            else:
                default_initializer = (init.global_weight_initializer()
                                       or init.XavierInitializer())
        initializer = attr.initializer or default_initializer
        name = attr.name or unique_name.generate(
            f"{self.name}.w" if not is_bias else f"{self.name}.b")
        if framework.in_dygraph_mode():
            return framework._current_tracer().create_parameter(
                name=name, shape=shape, dtype=dtype, initializer=initializer,
                trainable=attr.trainable, regularizer=attr.regularizer,
                need_clip=attr.need_clip)
        block = self.main_program.current_block()
        if block.program.global_block().has_var(name):
            return block.program.global_block().var(name)
        param = block.create_parameter(
            name=name, shape=shape, dtype=dtype, trainable=attr.trainable,
            initializer=initializer, regularizer=attr.regularizer,
            need_clip=attr.need_clip)
        initializer(param)  # appends the init op to the startup program
        return param

    def create_variable_for_type_inference(self, dtype="float32",
                                           stop_gradient=False):
        if framework.in_dygraph_mode():
            from ..dygraph.varbase import Tensor

            # a placeholder: the tracer fills it when the op runs
            return Tensor(stop_gradient=stop_gradient)
        block = self.main_program.current_block()
        return block.create_var(
            name=unique_name.generate(".".join([self.name, "tmp"])),
            dtype=dtype, shape=(), stop_gradient=stop_gradient)

    def create_variable(self, **kwargs):
        return self.main_program.current_block().create_var(**kwargs)

    def create_global_variable(self, persistable=False, **kwargs):
        return self.main_program.global_block().create_var(
            persistable=persistable, **kwargs)

    def append_activation(self, out_var, act: Optional[str]):
        if act is None:
            return out_var
        act_out = self.create_variable_for_type_inference(dtype=out_var.dtype)
        self.append_op(act, inputs={"X": out_var}, outputs={"Out": act_out})
        return act_out
