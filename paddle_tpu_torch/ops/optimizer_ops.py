"""Optimizer op lowerings: ``sgd``, ``momentum``, ``adagrad``, ``adam``,
``adamw``, ``adamax``, ``rmsprop``, ``adadelta``, ``lamb``,
``lars_momentum``, ``ftrl``, ``decayed_adagrad``, ``proximal_gd``,
``proximal_adagrad``, ``dpsgd``, ``dgc_clip_by_norm``, ``dgc_momentum``,
``dgc`` and ``average_accumulates``, and the static AMP's
``check_finite_and_unscale`` and ``update_loss_scaling`` (all
``torch.where`` on the device, no host read: an overflow step replays
inside the graph and leaves every parameter as it was).

Port of ``paddle_tpu/ops/optimizer_ops.py``. ``register_optimizer`` keeps
the JAX package's fp32 master arithmetic: inputs are widened to fp32 for
the update and each ``<Slot>Out`` is cast back to its ``<Slot>`` input's
dtype. The JAX package's ``adam``/``adamw`` take their fused pallas
kernel only for tile-aligned 2-D params on a TPU; the port's take the
fused CUDA kernel (``ops/fused_adam.py``) for every param, so no plain
update runs on the card, and the beta-pow updates stay here, in the
lowering, as in ``_adam_fused_maybe``. The kernel updates p and the
moments in place, the lowering multiplies the beta powers in place after
the kernel has read them (in order on one stream), and the op returns
those same tensors. In place is what a step replayed as a CUDA graph
needs: the graph reads each persistable at its captured address, so a
new tensor returned for ``Beta1PowOut`` would never reach the next step
(the executor would have to copy it back, two launches a parameter).

The other rules are plain torch, as they are plain ``jnp`` in the JAX
package (none has a TPU kernel), written to survive capture as a CUDA
graph: no host read of a device value and no Python branch on one.
Lamb's and LARS's trust ratios and DGC's rampup test against its step
variable on the device are ``torch.where``; DGC's top-k takes a k fixed
by the gradient's size. Their outputs are new tensors, which the
executor copies back into the persistables (inside the graph on the
card).

``dgc_momentum`` returns ``ParamOut`` and ``VelocityOut`` in their
inputs' dtypes, as every ``register_optimizer`` rule does. The JAX rule
returns the promotion of a bf16 parameter and the fp32 sparse gradient
(fp32), which its executor stores, so the parameter turns fp32 after the
first step; a step replayed at fixed addresses cannot change a tensor's
dtype, and an eager run must match it (``tests/test_torch_clip_optimizers.py``).
"""
from __future__ import annotations

import torch

from ..framework.registry import register_op
from . import fused_adam as _fa
from .random_ops import _normal_at


def _lr(ins):
    return ins["LearningRate"][0].reshape(())


# output slots not named <input slot>Out (ftrl)
_IRREGULAR = {"SquaredAccumOut": "SquaredAccumulator",
              "LinearAccumOut": "LinearAccumulator"}


def register_optimizer(name):
    """register_op for update rules with fp32 master arithmetic."""

    def deco(fn):
        def wrapped(ctx, ins, attrs):
            f32_ins = {slot: [a.float() if a.dtype.is_floating_point else a
                              for a in arrs]
                       for slot, arrs in ins.items()}
            res = {}
            for slot, val in fn(ctx, f32_ins, attrs).items():
                src = _IRREGULAR.get(slot) or (
                    slot[:-3] if slot.endswith("Out") else slot)
                ref = ins.get(src)
                res[slot] = val.to(ref[0].dtype) if ref is not None else val
            return res

        wrapped.__name__ = fn.__name__
        return register_op(name, stop_gradient=True)(wrapped)

    return deco


@register_optimizer("sgd")
def _sgd(ctx, ins, attrs):
    p, g = ins["Param"][0], ins["Grad"][0]
    return {"ParamOut": p - _lr(ins) * g}


@register_optimizer("momentum")
def _momentum(ctx, ins, attrs):
    p, g, v = ins["Param"][0], ins["Grad"][0], ins["Velocity"][0]
    mu = attrs.get("mu", 0.9)
    lr = _lr(ins)
    rd = attrs.get("regularization_coeff", 0.0)
    if attrs.get("regularization_method", "") == "l2_decay" and rd:
        g = g + rd * p
    v_out = mu * v + g
    if attrs.get("use_nesterov", False):
        p_out = p - (g + mu * v_out) * lr
    else:
        p_out = p - lr * v_out
    return {"ParamOut": p_out, "VelocityOut": v_out}


def _adam_fused(ins, attrs, weight_decay):
    """One fused Adam(W) step through the kernel wrapper (in place)."""
    p, g = ins["Param"][0], ins["Grad"][0]
    m1, m2 = ins["Moment1"][0], ins["Moment2"][0]
    b1p, b2p = ins["Beta1Pow"][0], ins["Beta2Pow"][0]
    b1 = attrs.get("beta1", 0.9)
    b2 = attrs.get("beta2", 0.999)
    p_out, m1_out, m2_out = _fa.fused_adam(
        p, g.contiguous(), m1, m2, ins["LearningRate"][0].float(),
        b1p.float(), b2p.float(), beta1=b1, beta2=b2,
        eps=attrs.get("epsilon", 1e-8), weight_decay=weight_decay)
    return {"ParamOut": p_out, "Moment1Out": m1_out, "Moment2Out": m2_out,
            "Beta1PowOut": b1p.mul_(b1), "Beta2PowOut": b2p.mul_(b2)}


# an update op's outputs are its inputs' vars: nothing to infer, and the
# kernel wrapper never sees a meta tensor
@register_op("adam", stop_gradient=True, skip_infer=True)
def _adam(ctx, ins, attrs):
    return _adam_fused(ins, attrs, 0.0)


@register_op("adamw", stop_gradient=True, skip_infer=True)
def _adamw(ctx, ins, attrs):
    coeff = attrs.get("coeff", 0.01) if attrs.get("with_decay", True) else 0.0
    return _adam_fused(ins, attrs, coeff)


@register_optimizer("adamax")
def _adamax(ctx, ins, attrs):
    p, g = ins["Param"][0], ins["Grad"][0]
    m, inf = ins["Moment"][0], ins["InfNorm"][0]
    b1p = ins["Beta1Pow"][0]
    b1 = attrs.get("beta1", 0.9)
    b2 = attrs.get("beta2", 0.999)
    eps = attrs.get("epsilon", 1e-8)
    m_out = b1 * m + (1 - b1) * g
    inf_out = torch.maximum(b2 * inf, torch.abs(g) + eps)
    p_out = p - (_lr(ins) / (1 - b1p.reshape(()))) * (m_out / inf_out)
    return {"ParamOut": p_out, "MomentOut": m_out, "InfNormOut": inf_out}


@register_optimizer("adagrad")
def _adagrad(ctx, ins, attrs):
    p, g, mom = ins["Param"][0], ins["Grad"][0], ins["Moment"][0]
    eps = attrs.get("epsilon", 1e-6)
    mom_out = mom + torch.square(g)
    p_out = p - _lr(ins) * g / (torch.sqrt(mom_out) + eps)
    return {"ParamOut": p_out, "MomentOut": mom_out}


@register_optimizer("rmsprop")
def _rmsprop(ctx, ins, attrs):
    p, g = ins["Param"][0], ins["Grad"][0]
    ms, mom = ins["MeanSquare"][0], ins["Moment"][0]
    rho = attrs.get("decay", 0.95)
    eps = attrs.get("epsilon", 1e-6)
    momentum = attrs.get("momentum", 0.0)
    lr = _lr(ins)
    ms_out = rho * ms + (1 - rho) * torch.square(g)
    if attrs.get("centered", False):
        mg_out = rho * ins["MeanGrad"][0] + (1 - rho) * g
        mom_out = momentum * mom + lr * g / torch.sqrt(
            ms_out - torch.square(mg_out) + eps)
        return {"ParamOut": p - mom_out, "MeanSquareOut": ms_out,
                "MeanGradOut": mg_out, "MomentOut": mom_out}
    mom_out = momentum * mom + lr * g / torch.sqrt(ms_out + eps)
    return {"ParamOut": p - mom_out, "MeanSquareOut": ms_out,
            "MomentOut": mom_out}


@register_optimizer("adadelta")
def _adadelta(ctx, ins, attrs):
    p, g = ins["Param"][0], ins["Grad"][0]
    avg_sq, avg_up = ins["AvgSquaredGrad"][0], ins["AvgSquaredUpdate"][0]
    rho = attrs.get("rho", 0.95)
    eps = attrs.get("epsilon", 1e-6)
    sq_out = rho * avg_sq + (1 - rho) * torch.square(g)
    update = -torch.sqrt((avg_up + eps) / (sq_out + eps)) * g
    up_out = rho * avg_up + (1 - rho) * torch.square(update)
    return {"ParamOut": p + update, "AvgSquaredGradOut": sq_out,
            "AvgSquaredUpdateOut": up_out}


@register_optimizer("lamb")
def _lamb(ctx, ins, attrs):
    p, g = ins["Param"][0], ins["Grad"][0]
    m1, m2 = ins["Moment1"][0], ins["Moment2"][0]
    b1p, b2p = ins["Beta1Pow"][0], ins["Beta2Pow"][0]
    b1 = attrs.get("beta1", 0.9)
    b2 = attrs.get("beta2", 0.999)
    eps = attrs.get("epsilon", 1e-6)
    wd = attrs.get("weight_decay", 0.01)
    m1_out = b1 * m1 + (1 - b1) * g
    m2_out = b2 * m2 + (1 - b2) * torch.square(g)
    m1_hat = m1_out / (1 - b1p.reshape(()))
    m2_hat = m2_out / (1 - b2p.reshape(()))
    r = m1_hat / (torch.sqrt(m2_hat) + eps) + wd * p
    w_norm = torch.linalg.vector_norm(p)
    r_norm = torch.linalg.vector_norm(r)
    trust = torch.where((w_norm > 0) & (r_norm > 0), w_norm / r_norm,
                        torch.ones_like(w_norm))
    return {"ParamOut": p - _lr(ins) * trust * r, "Moment1Out": m1_out,
            "Moment2Out": m2_out, "Beta1PowOut": b1p * b1,
            "Beta2PowOut": b2p * b2}


@register_optimizer("lars_momentum")
def _lars_momentum(ctx, ins, attrs):
    p, g, v = ins["Param"][0], ins["Grad"][0], ins["Velocity"][0]
    mu = attrs.get("mu", 0.9)
    coeff = attrs.get("lars_coeff", 0.001)
    wd = attrs.get("lars_weight_decay", 0.0005)
    eps = attrs.get("epsilon", 0.0)
    lr = _lr(ins)
    p_norm = torch.linalg.vector_norm(p)
    g_norm = torch.linalg.vector_norm(g)
    local_lr = torch.where((p_norm > 0) & (g_norm > 0),
                           lr * coeff * p_norm / (g_norm + wd * p_norm + eps),
                           lr)
    v_out = mu * v + local_lr * (g + wd * p)
    return {"ParamOut": p - v_out, "VelocityOut": v_out}


@register_op("dgc_clip_by_norm", stop_gradient=True)
def _dgc_clip_by_norm(ctx, ins, attrs):
    """clip_by_norm gated on the DGC rampup step: before
    ``rampup_begin_step`` the input passes through."""
    v = ins["X"][0]
    step = ins["current_step"][0].reshape(())
    begin = attrs.get("rampup_begin_step", 0.0)
    max_norm = attrs.get("max_norm", 1.0)
    norm = torch.sqrt(torch.sum(v.float() ** 2))
    clipped = v * torch.clamp(max_norm / torch.clamp(norm, min=1e-10),
                              max=1.0).to(v.dtype)
    return {"Out": torch.where(step < begin, v, clipped)}


@register_op("dgc_momentum", stop_gradient=True)
def _dgc_momentum(ctx, ins, attrs):
    """Momentum before ``rampup_begin_step``, plain SGD from it on (the
    momentum then lives in the dgc op's U accumulator)."""
    p, g, vel = ins["Param"][0], ins["Grad"][0], ins["Velocity"][0]
    lr = _lr(ins)
    step = ins["current_step"][0].reshape(())
    mu = attrs.get("mu", 0.9)
    begin = attrs.get("rampup_begin_step", 0.0)
    vel_new = mu * vel + g
    p_mom = p - lr * (g + mu * vel_new if attrs.get("use_nesterov", False)
                      else vel_new)
    p_sgd = p - lr * g
    use_momentum = step < begin
    # each output in its persistable's dtype (a bf16 parameter beside the
    # fp32 sparse gradient would otherwise come back fp32; see the module
    # docstring)
    return {"ParamOut": torch.where(use_momentum, p_mom, p_sgd).to(p.dtype),
            "VelocityOut": torch.where(use_momentum, vel_new,
                                       vel).to(vel.dtype)}


@register_op("dgc", stop_gradient=True)
def _dgc(ctx, ins, attrs):
    """Deep gradient compression: momentum-correct locally (U),
    accumulate (V), keep the top ``ratio`` of |V| (the threshold from a
    top-k of fixed k), emit that sparse gradient and keep the rest as
    error feedback; before ``rampup_begin_step`` the gradient passes
    through and U, V stay."""
    u, v, g = ins["U"][0], ins["V"][0], ins["Grad"][0]
    step = ins["current_step"][0].reshape(())
    m = attrs.get("m", 0.9)
    ratio = attrs.get("ratio", 0.001)
    begin = attrs.get("rampup_begin_step", 0.0)
    k = max(1, int(ratio * g.numel()))
    u_new = m * u + g if attrs.get("use_local_momentum", True) else u + g
    v_new = v + u_new
    thr = torch.topk(torch.abs(v_new.reshape(-1)), k).values[-1]
    mask = torch.abs(v_new) >= thr
    zero = torch.zeros_like(v_new)
    encoded = torch.where(mask, v_new, zero)
    active = step >= begin
    return {"U_out": torch.where(active, torch.where(mask, zero, u_new), u),
            "V_out": torch.where(active, torch.where(mask, zero, v_new), v),
            "EncodeGrad": torch.where(active, encoded, g),
            "Grad_out": torch.where(active, encoded, g),
            "GatherBuff": torch.zeros_like(g),
            "k": torch.full((), float(k), device=g.device)}


@register_optimizer("ftrl")
def _ftrl(ctx, ins, attrs):
    p, g = ins["Param"][0], ins["Grad"][0]
    sq, lin = ins["SquaredAccumulator"][0], ins["LinearAccumulator"][0]
    l1 = attrs.get("l1", 0.0)
    l2 = attrs.get("l2", 0.0)
    power = attrs.get("lr_power", -0.5)
    lr = _lr(ins)
    new_sq = sq + g.square()
    if power == -0.5:
        sigma = (torch.sqrt(new_sq) - torch.sqrt(sq)) / lr
        denom = torch.sqrt(new_sq) / lr + 2 * l2
    else:
        sigma = (torch.pow(new_sq, -power) - torch.pow(sq, -power)) / lr
        denom = torch.pow(new_sq, -power) / lr + 2 * l2
    lin_out = lin + g - sigma * p
    p_out = (torch.clamp(lin_out, -l1, l1) - lin_out) / denom
    return {"ParamOut": p_out, "SquaredAccumOut": new_sq,
            "LinearAccumOut": lin_out}


@register_optimizer("decayed_adagrad")
def _decayed_adagrad(ctx, ins, attrs):
    p, g, m = ins["Param"][0], ins["Grad"][0], ins["Moment"][0]
    decay = attrs.get("decay", 0.95)
    eps = attrs.get("epsilon", 1e-6)
    m_new = decay * m + (1 - decay) * g * g
    return {"ParamOut": p - _lr(ins) * g / (torch.sqrt(m_new) + eps),
            "MomentOut": m_new}


def _proximal(prox, lr, l1, l2):
    return (torch.sign(prox) * torch.clamp(torch.abs(prox) - lr * l1, min=0.0)
            / (1.0 + lr * l2))


@register_optimizer("proximal_gd")
def _proximal_gd(ctx, ins, attrs):
    """FOBOS: the l1 shrinkage and l2 decay of the plain SGD iterate."""
    p, g = ins["Param"][0], ins["Grad"][0]
    lr = _lr(ins)
    return {"ParamOut": _proximal(p - lr * g, lr, attrs.get("l1", 0.0),
                                  attrs.get("l2", 0.0))}


@register_optimizer("proximal_adagrad")
def _proximal_adagrad(ctx, ins, attrs):
    p, g, m = ins["Param"][0], ins["Grad"][0], ins["Moment"][0]
    m_new = m + g * g
    lr_eff = _lr(ins) / torch.sqrt(m_new + 1e-10)
    return {"ParamOut": _proximal(p - lr_eff * g, lr_eff,
                                  attrs.get("l1", 0.0), attrs.get("l2", 0.0)),
            "MomentOut": m_new}


@register_op("dpsgd", stop_gradient=True, uses_rng=True)
def _dpsgd(ctx, ins, attrs):
    """The gradient clipped to norm ``clip``, plus Gaussian noise of
    ``sigma * clip`` from the counter-based draw (the JAX package draws
    from threefry: the same distribution, other numbers)."""
    p, g = ins["Param"][0], ins["Grad"][0]
    clip = attrs.get("clip", 10.0)
    batch_size = attrs.get("batch_size", 16.0)
    sigma = attrs.get("sigma", 1.0)
    g = g / torch.clamp(torch.linalg.vector_norm(g) / clip, min=1.0)
    noise = sigma * clip * _normal_at(
        ctx.uniform(attrs.get("_rng_id", 0), g.shape))
    return {"ParamOut": (p - _lr(ins) * (g + noise) / batch_size).to(p.dtype)}


@register_op("check_finite_and_unscale", stop_gradient=True)
def _check_finite_and_unscale(ctx, ins, attrs):
    scale = ins["Scale"][0].reshape(())
    found_inf = torch.zeros((), dtype=torch.bool, device=scale.device)
    outs = []
    for v in ins["X"]:
        found_inf = found_inf | ~torch.isfinite(v).all()
        dt = torch.promote_types(v.dtype, scale.dtype)
        outs.append(v.to(dt) / scale)
    return {"Out": outs, "FoundInfinite": found_inf.reshape(1)}


@register_op("update_loss_scaling", stop_gradient=True)
def _update_loss_scaling(ctx, ins, attrs):
    """The dynamic loss scale: ``decr_every_n_nan_or_inf`` overflow steps
    in a row scale it by ``decr_ratio`` (not below 1),
    ``incr_every_n_steps`` good steps by ``incr_ratio``. The step counts
    come back int32, as in the JAX package."""
    found_inf = ins["FoundInfinite"][0].reshape(())
    prev = ins["PrevLossScaling"][0].reshape(())
    good = ins["InGoodSteps"][0].reshape(())
    bad = ins["InBadSteps"][0].reshape(())
    zero_g, zero_b = torch.zeros_like(good), torch.zeros_like(bad)
    good_new = torch.where(found_inf, zero_g, good + 1)
    bad_new = torch.where(found_inf, bad + 1, zero_b)
    scale_up = good_new >= attrs.get("incr_every_n_steps", 1000)
    scale_down = bad_new >= attrs.get("decr_every_n_nan_or_inf", 2)
    new_scale = torch.where(
        scale_down,
        torch.clamp(prev * attrs.get("decr_ratio", 0.5), min=1.0),
        torch.where(scale_up, prev * attrs.get("incr_ratio", 2.0), prev))
    good_new = torch.where(scale_up, zero_g, good_new)
    bad_new = torch.where(scale_down, zero_b, bad_new)
    return {"Out": [torch.where(found_inf, torch.zeros_like(v), v)
                    for v in ins.get("X", [])],
            "LossScaling": new_scale.reshape(1),
            "OutGoodSteps": good_new.to(torch.int32).reshape(1),
            "OutBadSteps": bad_new.to(torch.int32).reshape(1)}


@register_op("average_accumulates", stop_gradient=True)
def _average_accumulates(ctx, ins, attrs):
    """ModelAverage's accumulators: ``sum_1`` adds the parameter; once
    ``num_accumulates`` reaches the window, the sums shift down."""
    p = ins["param"][0]
    s1, s2, s3 = ins["in_sum_1"][0], ins["in_sum_2"][0], ins["in_sum_3"][0]
    n_acc = ins["in_num_accumulates"][0].reshape(()) + 1
    o_acc = ins["in_old_num_accumulates"][0].reshape(())
    n_upd = ins["in_num_updates"][0].reshape(()) + 1
    avg_window = attrs.get("average_window", 0.0)
    max_avg = attrs.get("max_average_window", 10000)
    min_avg = attrs.get("min_average_window", 10000)
    s1 = s1 + p
    window = torch.clamp(
        torch.clamp((n_upd.float() * avg_window).to(n_upd.dtype), max=max_avg),
        min=min_avg)
    overflow = n_acc >= window
    return {
        "out_sum_1": torch.where(overflow, torch.zeros_like(s1), s1),
        "out_sum_2": torch.where(overflow, torch.zeros_like(s2), s2),
        "out_sum_3": torch.where(overflow, s1 + s2, s3),
        "out_num_accumulates": torch.where(
            overflow, torch.zeros_like(n_acc), n_acc).reshape(1),
        "out_old_num_accumulates": torch.where(
            overflow, n_acc, o_acc).reshape(1),
        "out_num_updates": n_upd.reshape(1),
    }
