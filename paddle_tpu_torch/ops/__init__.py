"""Operator library of the port.

Importing this package registers every op lowering the port has (the
GPT training program's and the eager API's; mirrors ``paddle_tpu/ops``).
``api.py`` is the functional API over them (eager or static). Beside the
lowerings sit the hand-written CUDA kernels' wrappers
(``lmhead_ce.py``, ``fused_adam.py``,
``flash_attention.py``) and the build that compiles them
(``_build.py``).
"""
from . import (  # noqa: F401
    attention,
    control_flow_ops,
    fused_ops,
    math_ops,
    metric_ops,
    misc_ops,
    nn_ops,
    optimizer_ops,
    random_ops,
    tensor_ops,
    vision_ops,
)
