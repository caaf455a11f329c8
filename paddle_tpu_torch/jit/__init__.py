"""paddle.jit: a dygraph function compiled as one unit, and the export path.

Port of ``paddle_tpu/jit/__init__.py``. The JAX package wraps a forward
in ``jax.jit`` (``StaticFunction``: a cache keyed by the inputs' shapes
and dtypes, the layer's ``training`` flag and the kwarg names; outputs
that take no gradient). The port compiles the same call as a CUDA graph,
through ``framework/replay.py``'s ``Captured``:

- **A cache entry** (``jit/dy2static.py:Unit``) per key: the first call
  is an eager warm-up, the second is captured and replayed once, later
  calls replay. Each call copies its tensor inputs into the entry's
  static buffers and clones the outputs out of the graph's pool (the
  next replay overwrites them). The body runs with no tape and its
  outputs are ``stop_gradient=True``, as the reference's.
- **The key** is the reference's (input shapes and dtypes, ``training``,
  kwarg names) and what else changes the captured work: the kwargs'
  values, ``amp.auto_cast``'s state and dtype, the device, and the
  layer a method is bound to.
- **Parameters are read by address.** A capture notes every parameter
  its ops read and the storage it read; a call that finds one rebound
  (``set_value``, ``set_state_dict``, an update op's output) captures
  again (``StaticFunction.routes[key]["recaptures"]``), so a replay
  never reads stale weights.
- **Routes.** ``"graph"``: the whole call is one graph. ``"loop"``: the
  warm-up met a tensor-dependent ``if`` or loop (``dy2static``), so the
  call runs op by op, reading each decision on the host, each loop body
  a graph of its own. ``"eager"``: the device does not replay (the CPU,
  unless ``staged``; ``PADDLE_TPU_EAGER=1`` on the card) and the
  function runs as plain eager Python. ``StaticFunction.routes`` says
  which route each entry took, with its phases and host reads.
- **No hidden fallback.** A capture that fails raises, naming the
  function; nothing falls back to eager on its own.
- A compiled call made inside another compiled unit is inlined into it.

``jit.save`` records one forward into a tape ``Program`` (the tracer's
``record_all``) and writes it with ``Program.serialize_to_string`` beside
a pickle of the parameters, in the JAX package's files; ``jit.load``
returns a :class:`TranslatedLayer` that runs the program through the
static ``Executor`` (replayed on the card). A model saved by either
package loads in the other. Where the layer reads a tensor that is
neither a parameter nor an input (a buffer such as a position table),
the port saves it as a persistable too; the reference leaves it out of
the saved parameters, and its load then fails (ROADMAP.md, differences
kept on purpose).
"""
from __future__ import annotations

import functools
import os
import pickle
from typing import Any, Callable, Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from ..framework import core
from ..framework import replay as _replay
from . import dy2static

__all__ = ["InputSpec", "StaticFunction", "TranslatedLayer", "load", "save",
           "to_static"]


class InputSpec:
    """Reference paddle.static.InputSpec."""

    def __init__(self, shape, dtype="float32", name=None):
        self.shape = tuple(shape)
        self.dtype = dtype
        self.name = name


def _flatten(out) -> Tuple[list, Any]:
    """(leaves, spec) of a function's output: Tensors and other values
    inside tuples, lists and dicts."""
    if isinstance(out, (tuple, list)):
        leaves, specs = [], []
        for o in out:
            lv, sp = _flatten(o)
            leaves += lv
            specs.append((len(lv), sp))
        return leaves, (type(out), specs)
    if isinstance(out, dict):
        keys = list(out)
        leaves, spec = _flatten([out[k] for k in keys])
        return leaves, (dict, keys, spec)
    return [out], None


def _unflatten(spec, leaves):
    if spec is None:
        return leaves[0]
    if spec[0] is dict:
        _, keys, inner = spec
        return dict(zip(keys, _unflatten(inner, leaves)))
    kind, specs = spec
    out, i = [], 0
    for n, sp in specs:
        out.append(_unflatten(sp, leaves[i:i + n]))
        i += n
    return kind(out)


def _kwarg_key(v):
    try:
        hash(v)
        return v
    except TypeError:
        return ("id", id(v))


class _Entry:
    """One cache key's compiled unit: its route, its static input buffers
    and ``Captured`` (the graph route), and the parameters its capture
    read."""

    def __init__(self, unit: dy2static.Unit):
        self.unit = unit
        self.route: Optional[str] = None
        self.inputs: Optional[List[torch.Tensor]] = None
        self.run: Optional[_replay.Captured] = None
        self.reads = dy2static.Reads()
        self.spec = None
        self.recaptures = 0
        self.phases = {"eager": 0, "capture": 0, "replay": 0, "op": 0}

    def info(self) -> dict:
        return {"route": self.route, "phases": dict(self.phases),
                "recaptures": self.recaptures, **self.unit.counts,
                "constants": len(self.unit.constants.values),
                "loop_bodies": len(self.unit.loops)}


class StaticFunction:
    """``to_static``-wrapped callable: the function compiled per cache key
    (see the module docstring). ``staged`` takes the compiled route on
    the CPU too, with each graph's body called directly (tests)."""

    def __init__(self, function: Callable, input_spec=None, layer=None):
        self._function = function
        self._layer = layer
        self._input_spec = input_spec
        self._cache: Dict[Tuple, _Entry] = {}
        self.staged = False
        self.name = getattr(function, "__qualname__", repr(function))

    def __get__(self, instance, owner):
        if instance is None:
            return self
        return functools.partial(self.__call__, instance)

    @property
    def routes(self) -> Dict[Tuple, dict]:
        """{cache key: the entry's route, phases, recaptures and counts}."""
        return {k: e.info() for k, e in self._cache.items()}

    def __call__(self, *args, **kwargs):
        from .. import amp
        from ..dygraph.varbase import Tensor

        maybe_self = ()
        if args and hasattr(args[0], "parameters") \
                and not isinstance(args[0], Tensor):
            # bound-method style: first arg is the Layer
            if self._layer is None:
                self._layer = args[0]
            maybe_self = (args[0],)
            args = args[1:]
        ins = [a if isinstance(a, Tensor) else Tensor(np.asarray(a))
               for a in args]
        if dy2static.current() is not None:
            # called inside another compiled unit: inlined into it, as a
            # jax.jit call inside a jax.jit trace is
            return self._function(*maybe_self, *ins, **kwargs)
        device = (ins[0].place if ins else
                  core.resolve_device(core.default_place()))
        state = amp.amp_state()
        layer = maybe_self[0] if maybe_self else self._layer
        key = (
            tuple((t.shape, str(t.dtype)) for t in ins),
            bool(getattr(layer, "training", True)),
            tuple(sorted((k, _kwarg_key(v)) for k, v in kwargs.items())),
            (bool(state["enabled"]), state["dtype"], state["level"],
             tuple(sorted(state.get("extra_white", ()))),
             tuple(sorted(state.get("extra_black", ())))),
            str(device),
            id(layer) if maybe_self else None,  # the bound layer itself
        )
        entry = self._cache.get(key)
        if entry is None:
            entry = self._cache[key] = _Entry(dy2static.Unit(device,
                                                             self.name))

        def call(vals):
            return self._function(*maybe_self, *vals, **kwargs)

        if not _replay.replays(torch.device(device), self.staged):
            entry.route = "eager"
            entry.phases["eager"] += 1
            from ..dygraph.base import no_grad

            with no_grad():
                return self._outputs(call(ins))
        if entry.route == "loop":
            entry.phases["op"] += 1
            with dy2static.compiling(entry.unit, "op"):
                return self._outputs(call(ins))
        return self._graph(entry, ins, call)

    def _graph(self, entry: _Entry, ins, call):
        from ..dygraph.varbase import Tensor

        if entry.run is None:
            entry.inputs = [torch.empty_like(t._value) for t in ins]
            grads = [t.stop_gradient for t in ins]

            def body(replayed: bool):
                vals = [Tensor._wrap(b, g)
                        for b, g in zip(entry.inputs, grads)]
                with dy2static.compiling(
                        entry.unit, "capture" if replayed else "warm",
                        reads=entry.reads if replayed else None):
                    leaves, entry.spec = _flatten(call(vals))
                return [v._value if isinstance(v, Tensor) else v
                        for v in leaves]

            entry.run = _replay.Captured(body, entry.unit.device)
        elif entry.run.captured and not entry.reads.current():
            # a parameter rebound since the capture: capture again
            entry.recaptures += 1
            entry.reads = dy2static.Reads()
            entry.run = _replay.Captured(entry.run.body, entry.unit.device,
                                         warmup=0)
        for buf, t in zip(entry.inputs, ins):
            buf.copy_(t._value)
        try:
            outs, phase = entry.run()
        except Exception as e:
            e.add_note(f"to_static: while running {self.name} as a "
                       f"compiled unit")
            raise
        entry.phases[phase] += 1
        counts = entry.unit.counts
        if phase == "eager" and (counts["tensor_ifs"]
                                 or counts["tensor_loops"]):
            # tensor-dependent control flow: op by op from now on
            entry.route, entry.run, entry.inputs = "loop", None, None
        elif phase != "eager":
            entry.route = "graph"
        # cloned out: a replay overwrites the graph's outputs, and a
        # warm-up's may be an input buffer or a recorded constant
        return self._outputs(_unflatten(entry.spec, [
            Tensor._wrap(v.clone()) if isinstance(v, torch.Tensor) else v
            for v in outs]))

    @staticmethod
    def _outputs(out):
        """The call's outputs as Tensors that take no gradient."""
        from ..dygraph.varbase import Tensor

        leaves, spec = _flatten(out)
        res = []
        for v in leaves:
            if isinstance(v, Tensor):
                v = Tensor._wrap(v._value, stop_gradient=True)
            res.append(v)
        return _unflatten(spec, res)

    # reference API surface
    @property
    def code(self):
        import inspect

        return inspect.getsource(self._function)

    def concrete_program(self, *args):
        raise NotImplementedError("use paddle.jit.save to materialize a program")


def to_static(function=None, input_spec=None, build_strategy=None, backend=None):
    """Reference @paddle.jit.to_static / declarative (jit.py:156).

    backend=None/"ast" (default): the AST transpiler (jit/dy2static.py)
    rewrites tensor-dependent Python `if`/`while`/`for range` into the
    converters, so data-dependent control flow is decided per call;
    unsupported constructs raise Dy2StaticError when their condition is
    a tensor. backend="trace": no transform (a tensor-dependent branch
    raises Dy2StaticError, which the reference's jax.jit trace raises as
    a concretization error). A Layer's ``forward`` becomes the compiled
    call; the returned callable's ``static_function`` is the
    :class:`StaticFunction`."""

    def deco(fn):
        def maybe_ast(f):
            if backend == "trace":
                return f
            try:
                return dy2static.ast_transform(f)
            except dy2static.Dy2StaticError:
                if backend == "ast":
                    raise
                return f  # source unavailable: plain trace

        if hasattr(fn, "forward"):  # a Layer instance
            layer = fn
            sf = StaticFunction(
                maybe_ast(type(layer).forward), input_spec, layer=layer
            )
            layer.forward = functools.partial(sf.__call__, layer)
            layer.forward.static_function = sf
            return layer
        import inspect

        if inspect.ismethod(fn) and hasattr(fn.__self__, "parameters"):
            # bound layer method (to_static(model.forward)): transform the
            # UNDERLYING function and rebind its layer as self
            layer = fn.__self__
            sf = StaticFunction(maybe_ast(fn.__func__), input_spec,
                                layer=layer)
            bound = functools.partial(sf.__call__, layer)
            bound.static_function = sf
            return bound
        return StaticFunction(maybe_ast(fn), input_spec)

    if function is not None:
        return deco(function)
    return deco


# ---------------------------------------------------------------------------
# save / load via tape capture
# ---------------------------------------------------------------------------


def _capture_program(layer, input_spec: Sequence[InputSpec]):
    """Run one forward with the tape recording every op; returns
    (program, feed names, fetch names, params dict). A tensor the ops
    read that no op wrote and no feed gave (a layer's buffer) is saved
    with the parameters and made persistable in the program."""
    from ..dygraph.tracer import Tracer
    from ..dygraph.varbase import Tensor
    from ..framework import program as framework

    tracer = Tracer()
    tracer.record_all = True
    old = framework._switch_tracer(tracer)
    try:
        ins = []
        for i, spec in enumerate(input_spec):
            shape = [1 if (d is None or d < 0) else int(d) for d in spec.shape]
            arr = np.zeros(shape, spec.dtype)
            t = Tensor(arr, name=spec.name or f"feed_{i}", stop_gradient=True)
            tracer._tape_var(t)
            ins.append(t)
        layer.eval()
        out = layer(*ins)
        outs = out if isinstance(out, (list, tuple)) else [out]
        program = tracer.program
        feed_names = [t.name for t in ins]
        fetch_names = [o.name for o in outs]
        params = {name: core.host_numpy(p._value)
                  for name, p in tracer._params.items()}
        # layer params were created before this tracer: collect from layer
        for p in layer.parameters():
            params[p.name] = core.host_numpy(p._value)
        block = program.global_block()
        written = {n for op in block.ops for n in op.output_arg_names()}
        for name, var in block.vars.items():
            if not (name in params or name in written or name in feed_names):
                params[name] = core.host_numpy(tracer.env[name])
                var.persistable = True
        return program, feed_names, fetch_names, params
    finally:
        framework._switch_tracer(old)


def save(layer, path: str, input_spec: Optional[Sequence[InputSpec]] = None):
    """Reference paddle.jit.save: export a dygraph Layer to the inference
    model format (program + params) consumable by paddle.jit.load and the
    static Executor."""
    assert input_spec, "jit.save requires input_spec on this build"
    program, feeds, fetches, params = _capture_program(layer, input_spec)

    dirname = os.path.dirname(path) or "."
    base = os.path.basename(path)
    os.makedirs(dirname, exist_ok=True)
    with open(os.path.join(dirname, base + ".pdmodel"), "wb") as f:
        pickle.dump(
            {
                "program": program.serialize_to_string(),
                "feeds": feeds,
                "fetches": fetches,
            },
            f, protocol=4,
        )
    with open(os.path.join(dirname, base + ".pdiparams"), "wb") as f:
        pickle.dump(params, f, protocol=4)


class TranslatedLayer:
    """Reference TranslatedLayer: a loaded jit model behaving like a Layer;
    its program runs through an ``Executor`` on the default place (the
    card: replayed), its parameters in a scope of its own."""

    def __init__(self, program, feeds, fetches, params):
        from ..framework.executor import Executor, _host_tensor
        from ..framework.scope import Scope

        self._program = program
        self._feeds = feeds
        self._fetches = fetches
        self._scope = Scope()
        self._exe = Executor()
        block = program.global_block()
        for name, val in params.items():
            t = _host_tensor(val)
            var = block._find_var_recursive(name)
            if var is not None:
                t = t.to(core.convert_dtype(var.dtype))
            self._scope.set(name, t.to(self._exe.device))
        self.training = False

    def __call__(self, *inputs):
        from ..dygraph.varbase import Tensor

        feed = {
            n: (x._value if isinstance(x, Tensor) else np.asarray(x))
            for n, x in zip(self._feeds, inputs)
        }
        outs = self._exe.run(
            self._program, feed=feed, fetch_list=self._fetches,
            scope=self._scope, return_numpy=False,
        )
        res = [Tensor._wrap(o, stop_gradient=True) for o in outs]
        return res[0] if len(res) == 1 else res

    def eval(self):
        self.training = False
        return self

    def train(self):
        raise RuntimeError("TranslatedLayer is inference-only in this build")


def load(path: str) -> TranslatedLayer:
    """Reference paddle.jit.load."""
    from ..framework.program import Program

    with open(path + ".pdmodel", "rb") as f:
        payload = pickle.load(f)
    with open(path + ".pdiparams", "rb") as f:
        params = pickle.load(f)
    program = Program.parse_from_string(payload["program"])
    return TranslatedLayer(program, payload["feeds"], payload["fetches"], params)
