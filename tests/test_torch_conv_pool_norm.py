"""The vision, loss, metric and update ops the port lowers since the
vision slice, each against the JAX package.

One case per (op, dtype), built as a one-op program in each package on
the same numpy inputs: ``nn_ops.py``'s convolutions, pooling, norms,
losses, lookups and misc ops; ``mul``, ``top_k``, ``top_k_v2``,
``one_hot_v2``; ``metric_ops.py`` (``chunk_eval`` and
``positive_negative_pair`` are host ops, which the port's executor runs
eagerly); and ``optimizer_ops.py``'s AMP and remaining update ops. A
case with a target output also appends the generic ``<op>_grad`` with a
fed random cotangent. The JAX side runs in this process, inside
``enable_static()`` ... ``finally: disable_static()``.

Tolerances: fp32 outputs and gradients at rtol = atol = 1e-5; bf16 at
rtol = 2e-2 with an atol of 2e-2 of the reference tensor's largest
magnitude (both frameworks round a bf16 convolution's fp32 accumulation
once, but the windows and reductions add in other orders). Max pooling's
gradient goes to one winner of a window, which torch and XLA may pick
differently under ties: the inputs are random floats, with no ties.
``dpsgd`` runs at ``sigma`` 0 (no noise), since the two packages draw
from different generators.
"""
import torch_threads  # noqa: F401 (one torch thread a worker)
import zlib

import numpy as np
import pytest

import jax.numpy as jnp

import paddle_tpu as pd
from paddle_tpu import framework as jfw

import paddle_tpu_torch  # noqa: F401
from paddle_tpu_torch import framework as tfw
from torch_modes import static_mode  # noqa: F401

TOL = {"f32": 1e-5, "bf16": 2e-2, "bf16fwd": 2e-2}
F32, BOTH = ["f32"], ["f32", "bf16"]
# the JAX package's bf16 convolution has no backward (its VJP meets an
# fp32 cotangent beside bf16 operands, which lax refuses): forward only
CONV_DTS = ["f32", "bf16fwd"]


def _conv(op, x, w, target="Output", dts=CONV_DTS, **attrs):
    base = {"strides": [1, 1], "paddings": [0, 0], "dilations": [1, 1],
            "groups": 1}
    return (op, {"Input": [x], "Filter": [w]}, {**base, **attrs},
            {"Output": 1}, target, ["Input", "Filter"], dts)


def _pool(x, dts=BOTH, **attrs):
    base = {"pooling_type": "max", "ksize": [2, 2], "strides": [2, 2],
            "paddings": [0, 0]}
    return ("pool2d", {"X": [x]}, {**base, **attrs}, {"Out": 1}, "Out",
            ["X"], dts)


def _bn(x, c, dts=BOTH, **attrs):
    base = {"momentum": 0.9, "epsilon": 1e-5, "is_test": False,
            "data_layout": "NCHW", "use_global_stats": False}
    return ("batch_norm",
            {"X": [x], "Scale": [("pos", (c,))], "Bias": [(c,)],
             "Mean": [(c,)], "Variance": [("pos", (c,))]},
            {**base, **attrs},
            {"Y": 1, "MeanOut": 1, "VarianceOut": 1, "SavedMean": 1,
             "SavedVariance": 1}, "Y", ["X", "Scale", "Bias"], dts)


def _opt(op, ins, outs, **attrs):
    return (op, {"Param": [(4, 3)], "Grad": [(4, 3)],
                 "LearningRate": [("lr",)], **ins}, attrs,
            {o: 1 for o in outs}, None, [], F32)


# name: (op, inputs {slot: [spec]}, attrs, outputs {slot: count},
#        target slot or None, slots to differentiate, dtypes). A spec is a
# shape (normal numbers), ("pos"|"prob"|"bin"|"unit", shape),
# ("int", shape, high), ("lr",) or ("const", array).
_CASES = {
    "conv2d": _conv("conv2d", (2, 4, 7, 7), (6, 4, 3, 3), paddings=[1, 1]),
    "conv2d_groups_stride": _conv("conv2d", (2, 4, 8, 8), (6, 2, 3, 3),
                                  groups=2, strides=[2, 2]),
    "depthwise_conv2d": _conv("depthwise_conv2d", (2, 4, 6, 6),
                              (4, 1, 3, 3), groups=4, paddings=[1, 1]),
    "conv2d_dilation": _conv("conv2d", (1, 3, 9, 9), (4, 3, 3, 3),
                             dilations=[2, 2], paddings=[2, 2], dts=F32),
    "conv2d_same": _conv("conv2d", (1, 3, 7, 8), (4, 3, 3, 2),
                         strides=[2, 2], padding_algorithm="SAME", dts=F32),
    "conv2d_valid": _conv("conv2d", (1, 3, 6, 6), (4, 3, 3, 3),
                          paddings=[2, 2], padding_algorithm="VALID",
                          dts=F32),
    "conv2d_pad4": _conv("conv2d", (1, 3, 6, 6), (4, 3, 3, 3),
                         paddings=[1, 0, 2, 1], dts=F32),
    "conv2d_nhwc": _conv("conv2d", (2, 6, 6, 4), (3, 3, 4, 5),
                         paddings=[1, 1], data_format="NHWC"),
    "conv2d_transpose": _conv("conv2d_transpose", (2, 4, 5, 5),
                              (4, 3, 3, 3), strides=[2, 2], paddings=[1, 1]),
    "conv2d_transpose_groups": _conv("conv2d_transpose", (1, 4, 4, 4),
                                     (4, 2, 3, 3), groups=2,
                                     dilations=[2, 2], dts=F32),
    "conv2d_transpose_pad4": _conv("conv2d_transpose", (1, 2, 4, 4),
                                   (2, 3, 3, 3), strides=[2, 2],
                                   paddings=[1, 0, 0, 2], dts=F32),
    "conv3d": _conv("conv3d", (1, 2, 5, 5, 5), (3, 2, 3, 3, 3), dts=F32,
                    strides=[1, 1, 1], paddings=[1, 1, 1],
                    dilations=[1, 1, 1]),
    "max_pool": _pool((2, 3, 8, 8)),
    "max_pool_resnet": _pool((2, 3, 9, 9), ksize=[3, 3], paddings=[1, 1]),
    "max_pool_wide_pad": _pool((1, 2, 6, 6), ksize=[2, 2], strides=[1, 1],
                               paddings=[1, 2, 0, 1], dts=F32),
    "avg_pool": _pool((2, 3, 8, 8), pooling_type="avg"),
    "avg_pool_exclusive": _pool((2, 3, 9, 9), pooling_type="avg",
                                ksize=[3, 3], paddings=[1, 1]),
    "avg_pool_inclusive": _pool((2, 3, 9, 9), pooling_type="avg",
                                ksize=[3, 3], paddings=[1, 1],
                                exclusive=False, dts=F32),
    "avg_pool_asym_exclusive": _pool((1, 2, 6, 6), pooling_type="avg",
                                     ksize=[3, 3], strides=[1, 1],
                                     paddings=[1, 0, 0, 1], dts=F32),
    "avg_pool_wide_inclusive": _pool((1, 2, 6, 6), pooling_type="avg",
                                     ksize=[2, 2], strides=[1, 1],
                                     paddings=[2, 2], exclusive=False,
                                     dts=F32),
    "global_avg_pool": _pool((2, 3, 5, 5), pooling_type="avg",
                             global_pooling=True),
    "global_max_pool": _pool((2, 3, 5, 5), global_pooling=True, dts=F32),
    "adaptive_avg_pool": _pool((2, 3, 8, 6), pooling_type="avg",
                               ksize=[2, 3], adaptive=True),
    "adaptive_max_pool": _pool((2, 3, 8, 6), ksize=[4, 2], adaptive=True,
                               dts=F32),
    "max_pool2d_with_index": ("max_pool2d_with_index", {"X": [(2, 3, 6, 6)]},
                              {"ksize": [2, 2], "strides": [2, 2],
                               "paddings": [0, 0]},
                              {"Out": 1, "Mask": 1}, "Out", ["X"], F32),
    "batch_norm_train": _bn((4, 3, 5, 5), 3),
    "batch_norm_test": _bn((4, 3, 5, 5), 3, is_test=True),
    "batch_norm_global_stats": _bn((4, 3, 5, 5), 3, use_global_stats=True,
                                   dts=F32),
    "batch_norm_nhwc": _bn((4, 5, 5, 3), 3, data_layout="NHWC", dts=F32),
    "batch_norm_2d": _bn((6, 4), 4, dts=F32),
    "instance_norm": ("instance_norm",
                      {"X": [(2, 3, 4, 4)], "Scale": [("pos", (3,))],
                       "Bias": [(3,)]}, {"epsilon": 1e-5},
                      {"Y": 1, "SavedMean": 1, "SavedVariance": 1}, "Y",
                      ["X", "Scale", "Bias"], F32),
    "group_norm": ("group_norm",
                   {"X": [(2, 6, 3, 3)], "Scale": [("pos", (6,))],
                    "Bias": [(6,)]}, {"groups": 3, "epsilon": 1e-5},
                   {"Y": 1, "Mean": 1, "Variance": 1}, "Y",
                   ["X", "Scale", "Bias"], F32),
    "norm": ("norm", {"X": [(3, 5)]}, {"axis": 1, "epsilon": 1e-10},
             {"Out": 1, "Norm": 1}, "Out", ["X"], F32),
    "cross_entropy": ("cross_entropy",
                      {"X": [("prob", (4, 5))], "Label": [("int", (4, 1), 5)]},
                      {"soft_label": False}, {"Y": 1}, "Y", ["X"], F32),
    "cross_entropy_soft": ("cross_entropy",
                           {"X": [("prob", (4, 5))],
                            "Label": [("prob", (4, 5))]},
                           {"soft_label": True}, {"Y": 1}, "Y", ["X"], F32),
    "cross_entropy2": ("cross_entropy2",
                       {"X": [("prob", (4, 5))],
                        "Label": [("int", (4, 1), 5)]},
                       {}, {"Y": 1, "XShape": 1, "MatchX": 1}, "Y", ["X"],
                       F32),
    "smooth_l1_loss": ("smooth_l1_loss",
                       {"X": [(3, 4)], "Y": [(3, 4)],
                        "InsideWeight": [("pos", (3, 4))],
                        "OutsideWeight": [("pos", (3, 4))]},
                       {"sigma": 1.5}, {"Out": 1, "Diff": 1}, "Out", ["X"],
                       F32),
    "hinge_loss": ("hinge_loss", {"Logits": [(6, 1)],
                                  "Labels": [("bin", (6, 1))]},
                   {}, {"Loss": 1}, "Loss", ["Logits"], F32),
    "square_error_cost": ("square_error_cost", {"X": [(3, 4)], "Y": [(3, 4)]},
                          {}, {"Out": 1}, "Out", ["X"], F32),
    "lookup_table": ("lookup_table", {"W": [(10, 4)],
                                      "Ids": [("int", (5, 1), 10)]},
                     {"padding_idx": -1}, {"Out": 1}, "Out", ["W"], F32),
    "embedding": ("embedding", {"W": [(10, 4)], "Ids": [("int", (2, 3), 10)]},
                  {"padding_idx": 3}, {"Out": 1}, "Out", ["W"], F32),
    "label_smooth": ("label_smooth", {"X": [("prob", (3, 5))]},
                     {"epsilon": 0.1}, {"Out": 1}, "Out", ["X"], F32),
    "label_smooth_prior": ("label_smooth",
                           {"X": [("prob", (3, 5))],
                            "PriorDist": [("prob", (1, 5))]},
                           {"epsilon": 0.2}, {"Out": 1}, "Out", ["X"], F32),
    "pixel_shuffle": ("pixel_shuffle", {"X": [(1, 8, 3, 3)]},
                      {"upscale_factor": 2}, {"Out": 1}, "Out", ["X"], F32),
    "grid_sampler": ("grid_sampler", {"X": [(1, 2, 4, 5)],
                                      "Grid": [("unit", (1, 3, 3, 2))]},
                     {}, {"Output": 1}, "Output", ["X"], F32),
    "mul": ("mul", {"X": [(2, 3, 4)], "Y": [(12, 5)]},
            {"x_num_col_dims": 1, "y_num_col_dims": 1}, {"Out": 1}, "Out",
            ["X", "Y"], BOTH),
    "mul_col_dims_2": ("mul", {"X": [(2, 3, 4)], "Y": [(4, 5)]},
                       {"x_num_col_dims": 2, "y_num_col_dims": 1},
                       {"Out": 1}, "Out", ["X", "Y"], F32),
    "top_k_v2": ("top_k_v2", {"X": [(3, 6)]}, {"k": 2, "axis": -1,
                                               "largest": True},
                 {"Out": 1, "Indices": 1}, "Out", ["X"], F32),
    "top_k_v2_smallest_axis0": ("top_k_v2", {"X": [(5, 3)]},
                                {"k": 2, "axis": 0, "largest": False},
                                {"Out": 1, "Indices": 1}, "Out", ["X"], F32),
    "top_k": ("top_k", {"X": [(3, 6)]}, {"k": 3}, {"Out": 1, "Indices": 1},
              "Out", ["X"], F32),
    "one_hot_v2": ("one_hot_v2", {"X": [("int", (4, 1), 5)]}, {"depth": 5},
                   {"Out": 1}, None, [], F32),
    "one_hot_out_of_range": ("one_hot", {"X": [("const", np.array(
        [0, 4, 7, -1], np.int64))]}, {"depth": 5}, {"Out": 1}, None, [], F32),
    "accuracy": ("accuracy", {"Out": [(4, 2)], "Indices": [("int", (6, 2), 4)],
                              "Label": [("int", (6, 1), 4)]}, {},
                 {"Accuracy": 1, "Correct": 1, "Total": 1}, None, [], F32),
    "mean_iou": ("mean_iou", {"Predictions": [("int", (12,), 4)],
                              "Labels": [("int", (12,), 4)]},
                 {"num_classes": 4},
                 {"OutMeanIou": 1, "OutWrong": 1, "OutCorrect": 1}, None, [],
                 F32),
    "auc": ("auc", {"Predict": [("prob", (8, 2))],
                    "Label": [("int", (8, 1), 2)],
                    "StatPos": [("const", np.arange(11, dtype=np.int64)
                                 .reshape(1, 11) % 3)],
                    "StatNeg": [("const", np.ones((1, 11), np.int64))]},
            {}, {"AUC": 1, "StatPosOut": 1, "StatNegOut": 1}, None, [], F32),
    "precision_recall": ("precision_recall",
                         {"Indices": [("int", (7, 1), 3)],
                          "Labels": [("int", (7, 1), 3)],
                          "Weights": [("pos", (7, 1))],
                          "StatesInfo": [("pos", (3, 4))]},
                         {"class_number": 3},
                         {"BatchMetrics": 1, "AccumMetrics": 1,
                          "AccumStatesInfo": 1}, None, [], F32),
    "chunk_eval": ("chunk_eval", {"Inference": [("int", (3, 8), 5)],
                                  "Label": [("int", (3, 8), 5)],
                                  "SeqLength": [("const", np.array(
                                      [8, 5, 7], np.int64))]},
                   {"num_chunk_types": 2, "chunk_scheme": "IOB"},
                   {"Precision": 1, "Recall": 1, "F1-Score": 1,
                    "NumInferChunks": 1, "NumLabelChunks": 1,
                    "NumCorrectChunks": 1}, None, [], F32),
    "chunk_eval_iobes": ("chunk_eval", {"Inference": [("int", (2, 9), 9)],
                                        "Label": [("int", (2, 9), 9)]},
                         {"num_chunk_types": 2, "chunk_scheme": "IOBES"},
                         {"Precision": 1, "Recall": 1, "F1-Score": 1,
                          "NumInferChunks": 1, "NumLabelChunks": 1,
                          "NumCorrectChunks": 1}, None, [], F32),
    "positive_negative_pair": ("positive_negative_pair",
                               {"Score": [(10, 1)],
                                "Label": [("int", (10, 1), 3)],
                                "QueryID": [("int", (10, 1), 2)]},
                               {}, {"PositivePair": 1, "NegativePair": 1,
                                    "NeutralPair": 1}, None, [], F32),
    "check_finite_and_unscale": ("check_finite_and_unscale",
                                 {"X": [(3, 4), (5,)],
                                  "Scale": [("const", np.array(
                                      [1024.0], np.float32))]}, {},
                                 {"Out": 2, "FoundInfinite": 1}, None, [],
                                 F32),
    "check_finite_and_unscale_inf": ("check_finite_and_unscale",
                                     {"X": [(3, 4), ("const", np.array(
                                         [1.0, np.inf, 2.0], np.float32))],
                                      "Scale": [("const", np.array(
                                          [8.0], np.float32))]}, {},
                                     {"Out": 2, "FoundInfinite": 1}, None,
                                     [], F32),
    "update_loss_scaling_good": (
        "update_loss_scaling",
        {"X": [(3, 2)], "FoundInfinite": [("const", np.array([False]))],
         "PrevLossScaling": [("const", np.array([512.0], np.float32))],
         "InGoodSteps": [("const", np.array([2.0], np.float32))],
         "InBadSteps": [("const", np.array([1.0], np.float32))]},
        {"incr_every_n_steps": 3, "decr_every_n_nan_or_inf": 2,
         "incr_ratio": 2.0, "decr_ratio": 0.5},
        {"Out": 1, "LossScaling": 1, "OutGoodSteps": 1, "OutBadSteps": 1},
        None, [], F32),
    "update_loss_scaling_inf": (
        "update_loss_scaling",
        {"X": [(3, 2)], "FoundInfinite": [("const", np.array([True]))],
         "PrevLossScaling": [("const", np.array([1.5], np.float32))],
         "InGoodSteps": [("const", np.array([5], np.int32))],
         "InBadSteps": [("const", np.array([0], np.int32))]},
        {"incr_every_n_steps": 1000, "decr_every_n_nan_or_inf": 1,
         "incr_ratio": 2.0, "decr_ratio": 0.5},
        {"Out": 1, "LossScaling": 1, "OutGoodSteps": 1, "OutBadSteps": 1},
        None, [], F32),
    "average_accumulates": (
        "average_accumulates",
        {"param": [(4, 3)], "in_sum_1": [(4, 3)], "in_sum_2": [(4, 3)],
         "in_sum_3": [(4, 3)],
         "in_num_accumulates": [("const", np.array([4], np.int64))],
         "in_old_num_accumulates": [("const", np.array([2], np.int64))],
         "in_num_updates": [("const", np.array([9], np.int64))]},
        {"average_window": 0.5, "max_average_window": 8,
         "min_average_window": 5},
        {"out_sum_1": 1, "out_sum_2": 1, "out_sum_3": 1,
         "out_num_accumulates": 1, "out_old_num_accumulates": 1,
         "out_num_updates": 1}, None, [], F32),
    "ftrl": _opt("ftrl", {"SquaredAccumulator": [("pos", (4, 3))],
                          "LinearAccumulator": [(4, 3)]},
                 ["ParamOut", "SquaredAccumOut", "LinearAccumOut"],
                 l1=0.1, l2=0.2, lr_power=-0.5),
    "ftrl_power": _opt("ftrl", {"SquaredAccumulator": [("pos", (4, 3))],
                                "LinearAccumulator": [(4, 3)]},
                       ["ParamOut", "SquaredAccumOut", "LinearAccumOut"],
                       l1=0.0, l2=0.1, lr_power=-0.7),
    "decayed_adagrad": _opt("decayed_adagrad", {"Moment": [("pos", (4, 3))]},
                            ["ParamOut", "MomentOut"], decay=0.9,
                            epsilon=1e-6),
    "proximal_gd": _opt("proximal_gd", {}, ["ParamOut"], l1=0.05, l2=0.1),
    "proximal_adagrad": _opt("proximal_adagrad",
                             {"Moment": [("pos", (4, 3))]},
                             ["ParamOut", "MomentOut"], l1=0.05, l2=0.1),
    "dpsgd_no_noise": _opt("dpsgd", {}, ["ParamOut"], clip=0.5,
                           batch_size=4.0, sigma=0.0),
}

_PARAMS = [pytest.param(name, dt, id=f"{name}-{dt}")
           for name, case in _CASES.items() for dt in case[6]]


def _round_bf16(a):
    return np.asarray(jnp.asarray(a, jnp.bfloat16), np.float32)


def _make(spec, r):
    if not isinstance(spec[0], str):
        return np.asarray(r.randn(*spec), np.float32), True
    kind = spec[0]
    if kind == "int":
        return r.randint(0, spec[2], spec[1]).astype(np.int64), False
    if kind == "lr":
        return np.asarray(0.1, np.float32), False
    if kind == "const":
        return spec[1], False
    lo, hi = {"pos": (0.5, 1.5), "prob": (0.05, 0.95), "unit": (-1.0, 1.0),
              "bin": (0.0, 2.0)}[kind]
    arr = np.asarray(r.uniform(lo, hi, spec[1]), np.float32)
    if kind == "bin":
        arr = np.floor(arr)
    return arr, True


def _inputs(name, dt):
    """{slot: [(var name, array, takes the case dtype)]} from a seed."""
    r = np.random.RandomState(zlib.crc32(name.encode()) % 1000)
    out = {}
    for slot, specs in _CASES[name][1].items():
        vals = []
        for i, spec in enumerate(specs):
            arr, cast = _make(spec, r)
            if cast and dt != "f32":  # values both sides hold exactly
                arr = _round_bf16(arr)
            vals.append((f"{slot.lower()}_{i}", arr, cast))
        out[slot] = vals
    return out


def _build_and_run(fw, exe, name, dt, ins, to_feed):
    """The one-op program in package ``fw``, run: every output, then the
    gradients, as float32 numpy."""
    op_type, _, attrs, outs_spec, target, diff = _CASES[name][:6]
    if dt == "bf16fwd":
        target, dt = None, "bf16"
    main, startup = fw.Program(), fw.Program()
    feed = {}
    with fw.program_guard(main, startup):
        block = main.global_block()
        in_vars = {}
        for slot, vals in ins.items():
            vs = []
            for vname, arr, cast in vals:
                dtype = ("bfloat16" if cast and dt == "bf16"
                         else arr.dtype.name)
                vs.append(block.create_var(name=vname, shape=arr.shape,
                                           dtype=dtype))
                feed[vname] = to_feed(arr, dtype)
            in_vars[slot] = vs
        outs = {s: [block.create_var(name=f"{s.lower()}_out{i}")
                    for i in range(n)] for s, n in outs_spec.items()}
        block.append_op(op_type, inputs=in_vars, outputs=outs, attrs=attrs)
        fetch = [v for vs in outs.values() for v in vs]
        if target is not None:
            t = outs[target][0]
            r = np.random.RandomState(7)
            cot = block.create_var(name="cot", shape=t.shape, dtype=t.dtype)
            feed["cot"] = to_feed(
                _round_bf16(np.asarray(r.randn(*t.shape), np.float32)),
                "bfloat16" if dt == "bf16" else "float32")
            fetch += fw.gradients([t], [v for s in diff for v in in_vars[s]],
                                  target_gradients=[cot])
    res = exe.run(main, feed=feed, fetch_list=fetch, scope=fw.Scope())
    return [np.asarray(a, dtype=np.float32) for a in res]


def _jax(name, dt, ins):
    pd.enable_static()
    try:
        return _build_and_run(
            jfw, jfw.Executor(), name, dt, ins,
            lambda a, d: a.astype(jnp.bfloat16) if d == "bfloat16" else a)
    finally:
        pd.disable_static()


def _torch(name, dt, ins):
    import torch

    def to_feed(a, d):
        if d == "bfloat16":
            return torch.from_numpy(a).to(torch.bfloat16)
        return a

    return _build_and_run(tfw, tfw.Executor(tfw.CPUPlace()), name, dt, ins,
                          to_feed)


@pytest.mark.parametrize("name,dt", _PARAMS)
def test_op_and_grad_match_jax(name, dt):
    ins = _inputs(name, dt)
    want = _jax(name, dt, ins)
    got = _torch(name, dt, ins)
    assert len(got) == len(want)
    tol = TOL[dt]
    for i, (g, w) in enumerate(zip(got, want)):
        assert g.shape == w.shape, (name, i, g.shape, w.shape)
        atol = tol if dt == "f32" else tol * float(np.abs(w).max(initial=1.0))
        np.testing.assert_allclose(g, w, rtol=tol, atol=atol,
                                   err_msg=f"{name} {dt} fetch #{i}")


_REFUSED = {
    "adaptive_pool_not_dividing": (_pool((1, 1, 5, 5), pooling_type="avg",
                                         ksize=[2, 2], adaptive=True),
                                   "non-divisible"),
    "conv2d_transpose_same": (_conv("conv2d_transpose", (1, 2, 4, 5),
                                    (2, 3, 3, 3), strides=[2, 2],
                                    padding_algorithm="SAME"),
                              "String padding"),
}


@pytest.mark.parametrize("name", sorted(_REFUSED))
def test_what_the_reference_refuses_the_port_refuses(name):
    """Shared with the reference: adaptive pooling to sizes that do not
    divide the input, and ``SAME`` padding of a transposed convolution."""
    case, match = _REFUSED[name]
    _CASES[name] = case
    try:
        ins = _inputs(name, "f32")
        for run in (_jax, _torch):
            with pytest.raises(Exception, match=match):
                run(name, "f32", ins)
    finally:
        del _CASES[name]


def test_max_pool2d_with_index_mask_is_all_zero_as_the_reference():
    """Shared with the reference, recorded, not fixed (ROADMAP.md)."""
    got = _torch("max_pool2d_with_index", "f32",
                 _inputs("max_pool2d_with_index", "f32"))
    assert got[1].shape == (2, 3, 3, 3) and not got[1].any()
