"""GPT decoder LM: configuration and the static training-program builder.

Port of ``paddle_tpu/models/gpt.py``: ``GPTConfig``, ``build_forward``,
``resolve_lm_head_impl`` (the same flag rules; ``"pallas"`` selects the
Hopper kernels of ``ops/lmhead_ce.py``) and ``build_train_program``. The
programs are the JAX package's op for op, with the same parameter names
(``gpt.wte``, ``gpt.h<i>.attn.q.w``, ...), so one set of keyword
arguments builds the same model in either package and the same numpy
values (``weights.scope_from_numpy``) give the same step.
``tp_sharding_rules`` waits for the multi-device slice (ROADMAP A10).
"""
from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Dict, Optional, Tuple

from .. import flags as _flags
from ..framework import (LayerHelper, ParamAttr, Program, device_guard,
                         program_guard)
from ..framework import initializer as init
from ..static import nn as snn

__all__ = ["GPTConfig", "build_forward", "resolve_lm_head_impl",
           "build_train_program"]


@dataclass
class GPTConfig:
    vocab_size: int = 32000
    n_layer: int = 12
    n_head: int = 12
    d_model: int = 768
    d_ff: Optional[int] = None  # default 4*d_model
    max_seq_len: int = 1024
    dropout: float = 0.0
    dtype: str = "float32"
    tie_embeddings: bool = True
    # multi-device options of the JAX package, kept so a config
    # round-trips between the packages; the port runs one device (stage
    # tags are recorded, and no mesh carries a sequence axis)
    sequence_parallel_axis: str = ""
    pp_stages: int = 1
    attention_layout: str = ""
    fused_lm_head: Optional[object] = None

    @property
    def head_dim(self) -> int:
        return self.d_model // self.n_head

    @property
    def ffn_dim(self) -> int:
        return self.d_ff or 4 * self.d_model


def _param(helper: LayerHelper, name: str, shape, dtype, std: float = 0.02, zeros=False):
    ini = init.ConstantInitializer(0.0) if zeros else init.NormalInitializer(0.0, std)
    return helper.create_parameter(
        ParamAttr(name=name, initializer=ini), shape=shape, dtype=dtype
    )


def _linear(helper, x, name: str, d_in: int, d_out: int, dtype: str, std=0.02, bias=True):
    w = _param(helper, f"{name}.w", [d_in, d_out], dtype, std=std)
    out = snn.matmul(x, w)
    if bias:
        b = _param(helper, f"{name}.b", [d_out], dtype, zeros=True)
        out = snn.elementwise_add(out, b)
    return out


def _attention(helper, x, cfg: GPTConfig, lname: str, batch, seq):
    d, h, hd = cfg.d_model, cfg.n_head, cfg.head_dim
    # Layout: heads stay where the qkv matmul leaves them (BTHD), so the
    # graph has no transpose ops; only ring attention (sp) wants BHTD.
    layout = cfg.attention_layout or ("BHTD" if cfg.sequence_parallel_axis else "BTHD")
    qkv = []
    for part in ("q", "k", "v"):
        p = _linear(helper, x, f"{lname}.attn.{part}", d, d, cfg.dtype)
        p = snn.reshape(p, [batch, seq, h, hd])
        if layout == "BHTD":
            p = snn.transpose(p, [0, 2, 1, 3])
        qkv.append(p)
    q, k, v = qkv

    block = helper.main_program.current_block()
    out = helper.create_variable_for_type_inference(dtype=cfg.dtype)
    block.append_op(
        type="fused_attention_tpu",
        inputs={"Q": [q], "K": [k], "V": [v]},
        outputs={"Out": [out]},
        attrs={
            "is_causal": True,
            "dropout_p": cfg.dropout,
            "is_test": False,
            "layout": layout,
            "sequence_parallel_axis": cfg.sequence_parallel_axis,
        },
    )
    if layout == "BHTD":
        out = snn.transpose(out, [0, 2, 1, 3])
    out = snn.reshape(out, [batch, seq, d])
    # residual-scaled init on the output projection (GPT-2 trick)
    return _linear(
        helper, out, f"{lname}.attn.proj", d, d, cfg.dtype,
        std=0.02 / math.sqrt(2 * cfg.n_layer),
    )


def _mlp(helper, x, cfg: GPTConfig, lname: str):
    d, dff = cfg.d_model, cfg.ffn_dim
    hgelu = snn.gelu(_linear(helper, x, f"{lname}.mlp.fc_in", d, dff, cfg.dtype))
    return _linear(
        helper, hgelu, f"{lname}.mlp.fc_out", dff, d, cfg.dtype,
        std=0.02 / math.sqrt(2 * cfg.n_layer),
    )


def _layer_norm(x, name: str):
    return snn.layer_norm(
        x,
        begin_norm_axis=len(x.shape) - 1,
        param_attr=ParamAttr(name=f"{name}.scale", initializer=init.ConstantInitializer(1.0)),
        bias_attr=ParamAttr(name=f"{name}.bias", initializer=init.ConstantInitializer(0.0)),
    )


def build_forward(cfg: GPTConfig, tokens, batch: int, seq: int,
                  checkpoints_out: Optional[list] = None,
                  lm_head: bool = True):
    """Append the decoder forward to the current program; returns logits
    [B, T, V] — or, with lm_head=False, the (final hidden state, wte)
    pair the fused lm-head CE consumes. If `checkpoints_out` is given,
    the per-layer residual outputs are appended to it — the natural
    recompute boundaries (RecomputeOptimizer /
    append_backward_with_checkpoints)."""
    helper = LayerHelper("gpt")
    d = cfg.d_model
    pp = max(1, cfg.pp_stages)

    def stage_guard(s: int):
        return device_guard(f"tpu:{s}") if pp > 1 else device_guard(None)

    with stage_guard(0):
        wte = _param(helper, "gpt.wte", [cfg.vocab_size, d], cfg.dtype)
        wpe = _param(helper, "gpt.wpe", [cfg.max_seq_len, d], cfg.dtype)

        block = helper.main_program.current_block()
        tok_emb = helper.create_variable_for_type_inference(dtype=cfg.dtype)
        block.append_op(
            type="lookup_table_v2",
            inputs={"W": [wte], "Ids": [tokens]},
            outputs={"Out": [tok_emb]},
            attrs={},
        )
        pos = snn.slice(wpe, axes=[0], starts=[0], ends=[seq])
        x = snn.elementwise_add(tok_emb, pos)  # broadcast [T,D] over batch

    for i in range(cfg.n_layer):
        with stage_guard(i * pp // cfg.n_layer):
            ln = f"gpt.h{i}"
            a = _attention(helper, _layer_norm(x, f"{ln}.ln1"), cfg, ln, batch, seq)
            x = snn.elementwise_add(x, a)
            m = _mlp(helper, _layer_norm(x, f"{ln}.ln2"), cfg, ln)
            x = snn.elementwise_add(x, m)
            if checkpoints_out is not None:
                checkpoints_out.append(x)

    with stage_guard(pp - 1):
        x = _layer_norm(x, "gpt.lnf")
        if not lm_head:
            return x, wte
        if cfg.tie_embeddings:
            logits = snn.matmul(x, wte, transpose_y=True)
        else:
            logits = _linear(helper, x, "gpt.lm_head", d, cfg.vocab_size, cfg.dtype, bias=False)
    return logits


def resolve_lm_head_impl(cfg: GPTConfig) -> str:
    """The training loss path for this config: "pallas" (the fused
    kernels -- on the card ``csrc/lmhead_ce.cu`` -- the default),
    "chunked" (the JAX package's lax-loop path: token chunks whose
    logits the backward recomputes, ``ops/fused_ops.py``) or "off"
    (materialized logits). Resolution order:
    ``cfg.fused_lm_head`` when set (bools keep their historical chunked/
    off meaning), else the ``PADDLE_TPU_FUSED_LMHEAD`` env flag
    (auto/on/off/pallas/chunked). Either fused path requires tied
    embeddings and an unpipelined graph; "auto" degrades to "off" there,
    an explicit request falls back with the same rule (the chunked op
    itself guards nothing — the builder is the one gate)."""
    mode = cfg.fused_lm_head
    if mode is None:
        mode = str(_flags.env_flag("PADDLE_TPU_FUSED_LMHEAD") or "auto")
    if mode is True:
        mode = "chunked"
    elif mode is False:
        mode = "off"
    mode = str(mode).strip().lower()
    if mode == "on":
        mode = "chunked"
    if mode not in ("auto", "pallas", "chunked", "off"):
        raise ValueError(
            f"PADDLE_TPU_FUSED_LMHEAD/fused_lm_head must be one of "
            f"auto/on/off/pallas/chunked, got {mode!r}")
    eligible = cfg.tie_embeddings and max(1, cfg.pp_stages) == 1
    if mode == "auto":
        mode = "pallas" if eligible else "off"
    elif mode in ("pallas", "chunked") and not eligible:
        mode = "off"
    return mode


def build_train_program(
    cfg: GPTConfig, batch: int, seq: int
) -> Tuple[Program, Program, Dict[str, object]]:
    """Full LM training graph: tokens/labels feeds -> mean NLL loss.
    Returns (main, startup, io) where io holds tokens/labels/loss/
    checkpoints plus "logits" — which is None when the fused lm-head CE
    is active (io["fused_lm_head"] says which; the fused path never
    materializes logits, that being its point). Callers needing logits
    must pass fused_lm_head=False."""
    main, startup = Program(), Program()
    ckpts: list = []
    impl = resolve_lm_head_impl(cfg)
    use_fused = impl in ("pallas", "chunked")
    with program_guard(main, startup):
        tokens = snn.data("tokens", shape=[batch, seq], dtype="int64")
        labels = snn.data("labels", shape=[batch, seq], dtype="int64")
        if use_fused:
            hidden, wte = build_forward(
                cfg, tokens, batch, seq, checkpoints_out=ckpts, lm_head=False)
            block = main.current_block()
            loss = block.create_var(name="lm_ce_loss")
            block.append_op(
                type="fused_lm_head_ce",
                inputs={"X": [hidden], "W": [wte], "Label": [labels]},
                outputs={"Loss": [loss]},
                attrs={"chunk_size": 4096, "impl": impl},
            )
            logits = None
        else:
            logits = build_forward(cfg, tokens, batch, seq,
                                   checkpoints_out=ckpts)
            labels3 = snn.reshape(labels, [batch, seq, 1])
            loss = snn.softmax_with_cross_entropy(logits, labels3, axis=-1)
        avg_loss = snn.mean(loss)
    return main, startup, {
        "tokens": tokens,
        "labels": labels,
        "logits": logits,
        "loss": avg_loss,
        "checkpoints": ckpts,
        "fused_lm_head": use_fused,
        "lm_head_impl": impl,
    }
