"""ParamAttr: a parameter's name, initializer and training options.

Copy of ``paddle_tpu/framework/param_attr.py``."""
from __future__ import annotations

from typing import Optional

from .initializer import Initializer


class ParamAttr:
    def __init__(
        self,
        name: Optional[str] = None,
        initializer: Optional[Initializer] = None,
        learning_rate: float = 1.0,
        regularizer=None,
        trainable: bool = True,
        do_model_average: bool = True,
        need_clip: bool = True,
    ):
        self.name = name
        self.initializer = initializer
        self.learning_rate = learning_rate
        self.regularizer = regularizer
        self.trainable = trainable
        self.do_model_average = do_model_average
        self.need_clip = need_clip

    @staticmethod
    def _to_attr(arg) -> "ParamAttr":
        if arg is None:
            return ParamAttr()
        if isinstance(arg, (list, tuple)):
            return [ParamAttr._to_attr(a) for a in arg]
        if isinstance(arg, ParamAttr):
            return arg
        if isinstance(arg, str):
            return ParamAttr(name=arg)
        if isinstance(arg, Initializer):
            return ParamAttr(initializer=arg)
        if isinstance(arg, bool):
            return ParamAttr() if arg else False
        raise TypeError(f"cannot convert {arg!r} to ParamAttr")
