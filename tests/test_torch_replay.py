"""The compiled route (a step or a serving program captured as a CUDA
graph and replayed), exercised on the CPU.

There are no graphs on the CPU, so these tests set ``staged`` on the
Executor or the DecodeModel: the compiled route then runs with the
captured body called directly -- the same static-buffer staging of the
feeds, the learning rate and the serving inputs, the same binding of
persistables by address and copy-back of out-of-place writes, the same
clones out of the outputs, and the same warm-up, capture and replay
phases (``framework/replay.py``) that the card records and replays.

- Training, the tiny GPT of ``tests/test_torch_static_training.py``
  (einsum attention, and flash attention with
  ``PADDLE_TPU_FLASH_MIN_SEQ=128``): 3 staged steps equal 3 eager steps
  bit for bit (losses and every persistable), and match the JAX
  package's 3 steps at that file's tolerances (losses rtol 1e-4,
  persistables atol 1e-5; fp32 in both, another order of sums).
- The executor's compiled step: beta1_pow is 0.9 multiplied once more
  per step (in fp32), a parameter replaced in the scope between steps
  takes effect (a new capture binds it), a fetched tensor is not changed
  by the next step, a learning rate changed between steps reaches the
  step, a random draw advances every step under the staged route and
  equals the eager draw (the device's (seed, step) tensor, not a frozen
  draw), and each capture counts on ``executor_compile_total``.
- Serving: staged prefill, decode and score give the eager tokens, pages
  and NLL bit for bit, and the JAX ``DecodeModel``'s tokens (pages at
  1e-5, NLL at 1e-4, as ``tests/test_torch_serving_model.py``) on the
  same numpy parameters; prefill and decode programs are bound to one
  pages tensor.
"""
import torch_threads  # noqa: F401 (one torch thread a worker)
import numpy as np
import pytest
import torch

import paddle_tpu as pd
from paddle_tpu import serving as jserving
from paddle_tpu.framework import Executor as JExecutor
from paddle_tpu.framework import Scope as JScope
from paddle_tpu.framework import program_guard as jguard
from paddle_tpu.framework import unique_name as jnames
from paddle_tpu.models import gpt as jgpt
from paddle_tpu.optimizer import Adam as JAdam

from paddle_tpu_torch import monitor
from paddle_tpu_torch import serving as tserving
from paddle_tpu_torch.framework import (CPUPlace, Executor, Program, Scope,
                                        UniformInitializer, program_guard,
                                        replay, unique_name)
from paddle_tpu_torch.framework import executor as texecutor
from paddle_tpu_torch.models import gpt as tgpt
from paddle_tpu_torch.optimizer import Adam
from paddle_tpu_torch.weights import scope_from_numpy
from torch_modes import static_mode  # noqa: F401 (autouse fixture)

_CFG = dict(vocab_size=128, n_layer=2, n_head=2, d_model=32, max_seq_len=16)
_FLASH_CFG = dict(vocab_size=256, n_layer=2, n_head=2, d_model=128,
                  max_seq_len=128)
_LEGS = {"einsum": (_CFG, 1e-8), "flash": (_FLASH_CFG, 1e-5)}
_B = 2


def _batch(cfg, seed=0):
    r = np.random.RandomState(seed)
    shape = (_B, cfg["max_seq_len"])
    return {k: r.randint(0, cfg["vocab_size"], shape).astype(np.int64)
            for k in ("tokens", "labels")}


def _jax_run(cfg_kw, eps, steps, feed):
    """(losses, start, end): the JAX package's program from its own
    startup values, each persistable as numpy before and after."""
    pd.enable_static()
    try:
        with jnames.guard():
            cfg = jgpt.GPTConfig(**cfg_kw, dtype="float32")
            main, startup, io = jgpt.build_train_program(
                cfg, _B, cfg_kw["max_seq_len"])
            with jguard(main, startup):
                JAdam(learning_rate=1e-3, epsilon=eps).minimize(io["loss"])
        names = sorted(v.name for v in main.list_vars() if v.persistable)
        scope, exe = JScope(), JExecutor()
        exe.run(startup, scope=scope)
        start = {n: np.asarray(scope.get(n)) for n in names}
        losses = [float(exe.run(main, feed=feed, fetch_list=[io["loss"]],
                                scope=scope)[0]) for _ in range(steps)]
        return losses, start, {n: np.asarray(scope.get(n)) for n in names}
    finally:
        pd.disable_static()


def _program(cfg_kw=_CFG, eps=1e-8, lr=1e-3):
    """(main, io, opt): the port's tiny GPT train program with Adam."""
    with unique_name.guard():
        cfg = tgpt.GPTConfig(**cfg_kw)
        main, startup, io = tgpt.build_train_program(
            cfg, _B, cfg_kw["max_seq_len"])
        with program_guard(main, startup):
            opt = Adam(learning_rate=lr, epsilon=eps)
            opt.minimize(io["loss"])
    return main, startup, io, opt


def _start(main, startup):
    """Every persistable's startup value, as numpy (a CPU run)."""
    scope = Scope()
    Executor(CPUPlace()).run(startup, scope=scope)
    return {v.name: scope.get(v.name).numpy() for v in main.list_vars()
            if v.persistable}


def _run(main, io, start, feed, steps, staged, between=None):
    """(losses, {name: tensor}, executor): ``steps`` steps from
    ``start``, eagerly or staged; ``between(i, scope)`` runs before step
    ``i`` (from 0)."""
    scope = scope_from_numpy(start, Scope(), "cpu")
    exe = Executor(CPUPlace())
    exe.staged = staged
    losses = []
    for i in range(steps):
        if between is not None:
            between(i, scope)
        losses.append(float(exe.run(main, feed=feed, fetch_list=[io["loss"]],
                                    scope=scope)[0]))
    return losses, {n: scope.get(n) for n in start}, exe


@pytest.fixture
def flash_at_128(monkeypatch):
    monkeypatch.setenv("PADDLE_TPU_FLASH_MIN_SEQ", "128")
    monkeypatch.delenv("PADDLE_TPU_DISABLE_FLASH", raising=False)


@pytest.mark.parametrize("leg", ["einsum", "flash"])
def test_staged_steps_equal_eager_and_match_jax(leg, request):
    if leg == "flash":
        request.getfixturevalue("flash_at_128")
    from paddle_tpu_torch.ops import attention

    cfg_kw, eps = _LEGS[leg]
    feed = _batch(cfg_kw, seed=2)
    jl, start, jend = _jax_run(cfg_kw, eps, 3, feed)
    main, _, io, _ = _program(cfg_kw, eps)
    el, eend, _ = _run(main, io, start, feed, 3, staged=False)
    before = attention.FLASH_DISPATCH_COUNT
    sl, send, exe = _run(main, io, start, feed, 3, staged=True)
    assert (attention.FLASH_DISPATCH_COUNT > before) == (leg == "flash")
    assert exe.phases == {"eager": 1, "capture": 1, "replay": 1}
    assert sl == el
    for name in start:
        assert torch.equal(send[name], eend[name]), name
    np.testing.assert_allclose(sl, jl, rtol=1e-4)
    assert sl[-1] < sl[0]
    for name in jend:
        np.testing.assert_allclose(send[name].float().numpy(),
                                   jend[name].astype(np.float32), atol=1e-5,
                                   rtol=0, err_msg=name)


def test_beta1_pow_counts_the_steps():
    main, startup, io, _ = _program()
    start = _start(main, startup)
    _, end, exe = _run(main, io, start, _batch(_CFG), 4, staged=True)
    assert exe.phases == {"eager": 1, "capture": 1, "replay": 2}
    want = np.float32(0.9)  # the accumulator starts at beta1
    for _ in range(4):
        want = np.float32(want * np.float32(0.9))
    pows = [n for n in end if "_beta1_pow_" in n]
    assert pows
    for name in pows:
        assert end[name].numpy().tolist() == [want], name


def test_a_parameter_replaced_between_steps_takes_effect():
    main, startup, io, _ = _program()
    start = _start(main, startup)
    feed = _batch(_CFG)
    bumped = dict(start, **{"gpt.wte": start["gpt.wte"] * 2})

    def replace(i, scope):
        if i == 2:  # after the capture: the replay must see the new wte
            scope.set("gpt.wte", torch.from_numpy(bumped["gpt.wte"].copy()))

    sl, send, exe = _run(main, io, start, feed, 4, staged=True,
                         between=replace)
    # the same as eager steps that replace it at the same point
    el, eend, _ = _run(main, io, start, feed, 4, staged=False,
                       between=replace)
    assert sl == el and sl[2] != _run(main, io, start, feed, 3,
                                      staged=True)[0][2]
    assert exe.phases == {"eager": 1, "capture": 2, "replay": 1}
    for name in start:
        assert torch.equal(send[name], eend[name]), name


def test_a_fetched_tensor_is_not_changed_by_the_next_step():
    main, startup, io, _ = _program()
    start = _start(main, startup)
    scope = scope_from_numpy(start, Scope(), "cpu")
    exe = Executor(CPUPlace())
    exe.staged = True
    fetched = []
    for _ in range(4):
        loss, wte = exe.run(main, feed=_batch(_CFG),
                            fetch_list=[io["loss"], "gpt.wte"], scope=scope,
                            return_numpy=False)
        fetched.append((loss, wte, loss.clone(), wte.clone()))
    assert exe.phases["replay"] == 2
    for loss, wte, loss0, wte0 in fetched:
        assert torch.equal(loss, loss0) and torch.equal(wte, wte0)
    assert not torch.equal(fetched[0][1], fetched[-1][1])
    assert fetched[-1][1].data_ptr() != scope.get("gpt.wte").data_ptr()


def test_a_learning_rate_changed_between_steps_takes_effect():
    main, startup, io, opt = _program()
    start = _start(main, startup)
    feed = _batch(_CFG)
    lrs = [1e-3, 1e-3, 1e-3, 5e-3, 0.0]

    def schedule(i, scope):
        opt.set_lr(lrs[i])

    sl, send, _ = _run(main, io, start, feed, 5, staged=True,
                       between=schedule)
    el, eend, _ = _run(main, io, start, feed, 5, staged=False,
                       between=schedule)
    assert sl == el
    for name in start:
        assert torch.equal(send[name], eend[name]), name
    # the frozen schedule: lr 1e-3 at every step gives other parameters
    opt.set_lr(1e-3)
    _, frozen, _ = _run(main, io, start, feed, 5, staged=True)
    assert not torch.equal(frozen["gpt.wte"], send["gpt.wte"])
    # lr 0 at the last step: the parameters stop where step 4 left them
    _, four, _ = _run(main, io, start, feed, 4, staged=True,
                      between=schedule)
    assert torch.equal(four["gpt.wte"], send["gpt.wte"])


def test_a_random_draw_refuses_to_be_captured():
    """Once refused (a draw seeded on the host would repeat every
    replay), a draw is now made on the device from the executor's (seed,
    step) tensor, which each run advances: under the staged route the
    startup's initializer draws anew at its warm-up, its capture and its
    replay, each equal to an eager executor's draw at the same step."""
    startup = Program()
    startup.random_seed = 11
    block = startup.global_block()
    UniformInitializer(-1.0, 1.0)(
        block.create_var(name="w", shape=(64,), dtype="float32",
                         persistable=True), block)
    draws = {}
    for staged in (False, True):
        scope, exe = Scope(), Executor(CPUPlace())
        exe.staged = staged
        draws[staged] = []
        for _ in range(3):
            exe.run(startup, scope=scope)
            draws[staged].append(scope.get("w").clone())
        assert exe.seed_step.tolist() == [11, 3]
    assert exe.phases == {"eager": 1, "capture": 1, "replay": 1}
    for eager, staged in zip(draws[False], draws[True]):
        assert torch.equal(eager, staged)
    first, second, third = draws[True]
    assert not torch.equal(first, second) and not torch.equal(second, third)
    assert -1.0 <= float(first.min()) and float(first.max()) < 1.0


def test_each_capture_counts_as_a_compile(monkeypatch):
    monkeypatch.setattr(monitor, "_ENABLED", True)
    before = texecutor._M_COMPILE.value
    main, startup, io, _ = _program()
    start = _start(main, startup)
    _, _, exe = _run(main, io, start, _batch(_CFG), 3, staged=True)
    assert exe.phases["capture"] == 1
    assert texecutor._M_COMPILE.value == before + 1


def test_captured_runs_warm_up_capture_and_replay(monkeypatch):
    calls = []
    run = replay.Captured(lambda replayed: calls.append(replayed) or
                          len(calls), torch.device("cpu"), warmup=2)
    assert [run() for _ in range(5)] == [
        (1, "eager"), (2, "eager"), (3, "capture"), (4, "replay"),
        (5, "replay")]
    assert calls == [False, False, True, True, True]
    assert run.calls == {"eager": 2, "capture": 1, "replay": 2}
    assert replay.replays(torch.device("cpu")) is False
    assert replay.replays(torch.device("cpu"), staged=True) is True
    monkeypatch.delenv("PADDLE_TPU_EAGER", raising=False)
    assert replay.replays(torch.device("cuda")) is True
    monkeypatch.setenv("PADDLE_TPU_EAGER", "1")
    assert replay.replays(torch.device("cuda")) is False


def test_capture_collects_the_garbage_first(monkeypatch):
    """A capture first collects the garbage (an unreachable graph in a
    reference cycle, destroyed by the collector mid-capture, would
    invalidate the capture), leaves the collector as it was, and ends the
    capture before it raises the body's error. CUDA's graph calls are
    stubbed: the CPU has none."""
    import contextlib
    import gc

    events = []

    class Graph:
        def replay(self):
            events.append("replay")

    @contextlib.contextmanager
    def graph(g, pool=None, capture_error_mode="global"):
        events.append(("begin", capture_error_mode))
        yield
        events.append("end")

    monkeypatch.setattr(torch.cuda, "CUDAGraph", Graph)
    monkeypatch.setattr(torch.cuda, "graph", graph)
    monkeypatch.setattr(torch.cuda, "device",
                        lambda dev: contextlib.nullcontext())
    monkeypatch.setattr(replay.gc, "collect",
                        lambda: events.append("collect"))
    assert gc.isenabled()

    def body(replayed):
        events.append(("body", replayed))
        return 7

    assert replay.Captured(body, torch.device("cpu"))._record() == 7
    assert events == ["collect", ("begin", "thread_local"),
                      ("body", True), "end", "replay"]
    assert gc.isenabled()

    def broken(replayed):
        raise ValueError("refused")

    events.clear()
    with pytest.raises(ValueError, match="refused"):
        replay.Captured(broken, torch.device("cpu"))._record()
    assert events == ["collect", ("begin", "thread_local"), "end"]
    assert gc.isenabled()


# -- serving ------------------------------------------------------------

_SCFG = dict(vocab_size=128, n_layer=2, n_head=2, d_model=32, max_seq_len=64)
_ENV = dict(max_batch=4, n_blocks=16, block_size=8, prefill_buckets=[16, 32])


def _rich_params(seed=1):
    """init_params' names and shapes, every value random at a scale
    that keeps each layer's activations O(1) (as
    tests/test_torch_serving_model.py)."""
    r = np.random.RandomState(seed)
    out = {}
    for name, a in jserving.init_params(jserving.GPTConfig(**_SCFG),
                                        seed).items():
        if name.endswith(".scale"):
            v = 1.0 + 0.2 * r.randn(*a.shape)
        elif name.endswith((".b", ".bias")):
            v = 0.2 * r.randn(*a.shape)
        elif name in ("gpt.wte", "gpt.wpe"):
            v = 0.5 * r.randn(*a.shape)
        else:
            v = r.randn(*a.shape) / np.sqrt(a.shape[0])
        out[name] = v.astype(np.float32)
    return out


def _serve(model, prompts, ticks=4):
    """(first tokens, decode tokens per tick, pages, scores) of two
    requests prefilled into their own blocks and decoded together."""
    pages = model.init_pages()
    blocks = [[1, 2, 3, 4], [5, 6, 7, 8]]
    firsts = []
    for prompt, ids in zip(prompts, blocks):
        pages, tok = model.prefill(pages, prompt, len(prompt), ids)
        firsts.append(tok)
    tables = np.zeros((4, model.max_blocks_per_req), np.int32)
    tables[0, :4], tables[2, :4] = blocks
    lens = np.zeros(4, np.int32)
    lens[[0, 2]] = [len(p) for p in prompts]
    toks = np.zeros(4, np.int32)
    toks[[0, 2]] = firsts
    out = []
    for _ in range(ticks):
        pages, toks = model.decode(pages, tables, lens, toks)
        out.append(np.asarray(toks)[[0, 2]].tolist())
        lens[[0, 2]] += 1
    scores = [model.score(p) for p in prompts]
    pages = pages.numpy() if isinstance(pages, torch.Tensor) else \
        np.asarray(pages)
    return firsts, out, pages[:, :, 1:], scores  # block 0 is scratch


def test_staged_serving_equals_eager_and_matches_jax():
    params = _rich_params()
    r = np.random.RandomState(4)
    prompts = [r.randint(1, 128, size=n).astype(np.int32) for n in (13, 27)]
    jm = jserving.DecodeModel(jserving.GPTConfig(**_SCFG), params=params,
                              **_ENV)
    eager = tserving.DecodeModel(tserving.GPTConfig(**_SCFG), params=params,
                                 device="cpu", **_ENV)
    staged = tserving.DecodeModel(tserving.GPTConfig(**_SCFG), params=params,
                                  device="cpu", **_ENV)
    staged.staged = True
    got, want, ref = (_serve(staged, prompts), _serve(eager, prompts),
                      _serve(jm, prompts))
    assert got[0] == want[0] == ref[0]
    assert got[1] == want[1] == ref[1]
    np.testing.assert_array_equal(got[2], want[2])
    np.testing.assert_allclose(got[2], ref[2], rtol=1e-5, atol=1e-5)
    for (gn, gt), (wn, wt), (rn, rt) in zip(got[3], want[3], ref[3]):
        np.testing.assert_array_equal(gn, wn)
        assert gt == wt
        np.testing.assert_allclose(gn, rn, rtol=1e-4, atol=1e-4)
    phases = {str(k): p.run.calls for k, p in staged._programs.items()}
    assert phases["decode"] == {"eager": 1, "capture": 1, "replay": 2}
    assert phases["('score', 16)"] == {"eager": 1, "capture": 0,
                                       "replay": 0}


def test_a_dropped_program_frees_its_graph_without_the_collector():
    """Neither a serving program nor its model is in a reference cycle:
    with the cyclic collector off, a program bound to other pages, and
    then the model with its programs, are freed (with their graphs) when
    their last reference goes."""
    import gc
    import weakref

    model = tserving.DecodeModel(tserving.GPTConfig(**_SCFG),
                                 params=_rich_params(), device="cpu", **_ENV)
    model.staged = True
    collecting = gc.isenabled()
    gc.disable()
    try:
        _serve(model, [np.arange(1, 14, dtype=np.int32)], ticks=2)
        bound = [weakref.ref(p.run) for p in model._programs.values()
                 if p.pages is not None]
        assert len(bound) == 2  # decode and one prefill bucket
        _serve(model, [np.arange(1, 14, dtype=np.int32)], ticks=2)  # new pages
        assert all(r() is None for r in bound)
        kept = [weakref.ref(p.run) for p in model._programs.values()]
        gone = weakref.ref(model)
        del model
        assert gone() is None
        assert all(r() is None for r in kept)
    finally:
        if collecting:
            gc.enable()


def test_programs_are_bound_to_one_pages_tensor():
    """A graph writes the pages it was captured on: a call with other
    pages drops the programs bound to the old ones and warms anew;
    ``warm(pages=...)`` leaves them captured, so traffic only replays."""
    model = tserving.DecodeModel(tserving.GPTConfig(**_SCFG),
                                 params=_rich_params(), device="cpu", **_ENV)
    model.staged = True
    model.warm(full=True)  # a one-block scratch set
    scratch = {k: p for k, p in model._programs.items() if p.pages is not None}
    assert scratch and all(p.run.calls["capture"] == 0
                           for p in scratch.values())
    pages = model.init_pages()
    model.warm(full=True, pages=pages)
    bound = [p for p in model._programs.values() if p.pages is not None]
    assert {id(p.pages) for p in bound} == {id(pages)}
    assert all(p.run.captured for p in model._programs.values())
    assert not torch.any(pages[:, :, 1:])  # only scratch block 0 written
    B = model.max_batch
    model.decode(pages, np.zeros((B, model.max_blocks_per_req)),
                 np.zeros(B), np.zeros(B))
    assert model._programs["decode"].run.calls["replay"] == 1
