"""CompiledProgram: the fluid scripts' multi-device entry point, on one
device.

Port of ``paddle_tpu/framework/compiler.py``
(``CompiledProgram(program).with_data_parallel(loss_name, build_strategy,
exec_strategy, places)``). ``Executor.run`` unwraps a
``CompiledProgram`` to its program, as the JAX executor does, so a
reference-style script (``exe.run(compiled_prog, ...)``) runs unchanged:
replayed as a CUDA graph on the card, eager on the CPU. The JAX package
attaches a ``dp`` mesh over its places; the port runs one device only,
and ``with_data_parallel`` over more than one place (or, with no
``places``, with more than one card visible) raises ``Unimplemented``
naming ROADMAP A10, never running quietly on one card. The strategies'
knobs are accepted and steer nothing, as there.
"""
from __future__ import annotations

from typing import Optional, Sequence

import torch

from . import errors as _errs


class BuildStrategy:
    """The knobs of the reference's build strategy, accepted."""

    class ReduceStrategy:
        AllReduce = 0
        Reduce = 1

    def __init__(self):
        self.reduce_strategy = BuildStrategy.ReduceStrategy.AllReduce
        self.gradient_scale_strategy = None
        self.memory_optimize = None
        self.enable_inplace = None
        self.fuse_all_reduce_ops = True


class ExecutionStrategy:
    def __init__(self):
        self.num_threads = 1
        self.num_iteration_per_drop_scope = 1


class CompiledProgram:
    def __init__(self, program_or_graph,
                 build_strategy: Optional[BuildStrategy] = None):
        self._program = program_or_graph
        self._build_strategy = build_strategy
        self._loss_name = None

    def with_data_parallel(self, loss_name: Optional[str] = None,
                           build_strategy: Optional[BuildStrategy] = None,
                           exec_strategy: Optional[ExecutionStrategy] = None,
                           share_vars_from=None,
                           places: Optional[Sequence] = None):
        n = len(list(places)) if places else max(torch.cuda.device_count(),
                                                  1)
        if n > 1:
            raise _errs.errors.Unimplemented(
                f"CompiledProgram.with_data_parallel over {n} devices: the "
                f"port runs one device; data parallelism over several comes "
                f"with the multi-device slice (ROADMAP.md queue A, item A10)")
        self._loss_name = loss_name
        if build_strategy is not None:
            self._build_strategy = build_strategy
        return self

    def _unwrap(self):
        """The program ``Executor.run`` runs."""
        return self._program
