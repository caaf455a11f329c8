"""Transformer layers: MultiHeadAttention, encoder/decoder stacks.

Port of ``paddle_tpu/nn/transformer.py``, op for op: attention goes
through the fused ``fused_attention_tpu`` op (the flash kernels of
``ops/flash_attention.py`` at long sequences), on heads split to
(B, H, T, D) by the reference's reshape and transpose and merged back the
same way.
"""
from __future__ import annotations

from . import functional as F
from .common import Dropout, LayerList, LayerNorm, Linear
from .layers import Layer
from ..ops import api as _api


class MultiHeadAttention(Layer):
    def __init__(self, embed_dim, num_heads, dropout=0.0, kdim=None, vdim=None, need_weights=False, weight_attr=None, bias_attr=None):
        super().__init__()
        self.embed_dim = embed_dim
        self.num_heads = num_heads
        self.head_dim = embed_dim // num_heads
        assert self.head_dim * num_heads == embed_dim
        self.dropout = dropout
        self.need_weights = need_weights
        kdim = kdim or embed_dim
        vdim = vdim or embed_dim
        self.q_proj = Linear(embed_dim, embed_dim, weight_attr, bias_attr)
        self.k_proj = Linear(kdim, embed_dim, weight_attr, bias_attr)
        self.v_proj = Linear(vdim, embed_dim, weight_attr, bias_attr)
        self.out_proj = Linear(embed_dim, embed_dim, weight_attr, bias_attr)

    def _split_heads(self, x):
        b, t = x.shape[0], x.shape[1]
        x = _api.reshape(x, [b, t, self.num_heads, self.head_dim])
        return _api.transpose(x, [0, 2, 1, 3])

    def forward(self, query, key=None, value=None, attn_mask=None, cache=None):
        key = query if key is None else key
        value = key if value is None else value
        q = self._split_heads(self.q_proj(query))
        k = self._split_heads(self.k_proj(key))
        v = self._split_heads(self.v_proj(value))
        out = F.scaled_dot_product_attention(
            q, k, v, attn_mask=attn_mask, dropout_p=self.dropout if self.training else 0.0,
            training=self.training,
        )
        b, t = query.shape[0], query.shape[1]
        out = _api.transpose(out, [0, 2, 1, 3])
        out = _api.reshape(out, [b, t, self.embed_dim])
        return self.out_proj(out)


class TransformerEncoderLayer(Layer):
    def __init__(
        self,
        d_model,
        nhead,
        dim_feedforward,
        dropout=0.1,
        activation="relu",
        attn_dropout=None,
        act_dropout=None,
        normalize_before=False,
        weight_attr=None,
        bias_attr=None,
    ):
        super().__init__()
        self._config = dict(
            d_model=d_model, nhead=nhead, dim_feedforward=dim_feedforward,
            dropout=dropout, activation=activation, attn_dropout=attn_dropout,
            act_dropout=act_dropout, normalize_before=normalize_before,
        )
        self.normalize_before = normalize_before
        self.self_attn = MultiHeadAttention(d_model, nhead, attn_dropout if attn_dropout is not None else dropout)
        self.linear1 = Linear(d_model, dim_feedforward, weight_attr, bias_attr)
        self.linear2 = Linear(dim_feedforward, d_model, weight_attr, bias_attr)
        self.norm1 = LayerNorm(d_model)
        self.norm2 = LayerNorm(d_model)
        self.dropout1 = Dropout(dropout)
        self.dropout2 = Dropout(dropout)
        self.dropout_act = Dropout(act_dropout if act_dropout is not None else dropout)
        self.activation = activation

    def _act(self, x):
        return F.gelu(x) if self.activation == "gelu" else F.relu(x)

    def forward(self, src, src_mask=None, cache=None):
        residual = src
        if self.normalize_before:
            src = self.norm1(src)
        src = self.self_attn(src, src, src, attn_mask=src_mask)
        src = residual + self.dropout1(src)
        if not self.normalize_before:
            src = self.norm1(src)
        residual = src
        if self.normalize_before:
            src = self.norm2(src)
        src = self.linear2(self.dropout_act(self._act(self.linear1(src))))
        src = residual + self.dropout2(src)
        if not self.normalize_before:
            src = self.norm2(src)
        return src


class TransformerEncoder(Layer):
    def __init__(self, encoder_layer, num_layers, norm=None):
        super().__init__()
        # rebuild (not deepcopy) per layer: fresh parameters with fresh names
        self.layers = LayerList(
            [encoder_layer]
            + [type(encoder_layer)(**encoder_layer._config) for _ in range(num_layers - 1)]
        )
        self.num_layers = num_layers
        self.norm = norm

    def forward(self, src, src_mask=None):
        out = src
        for layer in self.layers:
            out = layer(out, src_mask=src_mask)
        if self.norm is not None:
            out = self.norm(out)
        return out


class TransformerDecoderLayer(Layer):
    def __init__(self, d_model, nhead, dim_feedforward, dropout=0.1, activation="relu", normalize_before=False):
        super().__init__()
        self._config = dict(
            d_model=d_model, nhead=nhead, dim_feedforward=dim_feedforward,
            dropout=dropout, activation=activation, normalize_before=normalize_before,
        )
        self.normalize_before = normalize_before
        self.self_attn = MultiHeadAttention(d_model, nhead, dropout)
        self.cross_attn = MultiHeadAttention(d_model, nhead, dropout)
        self.linear1 = Linear(d_model, dim_feedforward)
        self.linear2 = Linear(dim_feedforward, d_model)
        self.norm1 = LayerNorm(d_model)
        self.norm2 = LayerNorm(d_model)
        self.norm3 = LayerNorm(d_model)
        self.dropout1 = Dropout(dropout)
        self.dropout2 = Dropout(dropout)
        self.dropout3 = Dropout(dropout)
        self.activation = activation

    def _act(self, x):
        return F.gelu(x) if self.activation == "gelu" else F.relu(x)

    def forward(self, tgt, memory, tgt_mask=None, memory_mask=None, cache=None):
        residual = tgt
        if self.normalize_before:
            tgt = self.norm1(tgt)
        tgt = self.self_attn(tgt, tgt, tgt, attn_mask=tgt_mask)
        tgt = residual + self.dropout1(tgt)
        if not self.normalize_before:
            tgt = self.norm1(tgt)
        residual = tgt
        if self.normalize_before:
            tgt = self.norm2(tgt)
        tgt = self.cross_attn(tgt, memory, memory, attn_mask=memory_mask)
        tgt = residual + self.dropout2(tgt)
        if not self.normalize_before:
            tgt = self.norm2(tgt)
        residual = tgt
        if self.normalize_before:
            tgt = self.norm3(tgt)
        tgt = self.linear2(self._act(self.linear1(tgt)))
        tgt = residual + self.dropout3(tgt)
        if not self.normalize_before:
            tgt = self.norm3(tgt)
        return tgt


class TransformerDecoder(Layer):
    def __init__(self, decoder_layer, num_layers, norm=None):
        super().__init__()
        self.layers = LayerList(
            [decoder_layer]
            + [type(decoder_layer)(**decoder_layer._config) for _ in range(num_layers - 1)]
        )
        self.norm = norm

    def forward(self, tgt, memory, tgt_mask=None, memory_mask=None):
        out = tgt
        for layer in self.layers:
            out = layer(out, memory, tgt_mask=tgt_mask, memory_mask=memory_mask)
        if self.norm is not None:
            out = self.norm(out)
        return out


class Transformer(Layer):
    def __init__(self, d_model=512, nhead=8, num_encoder_layers=6, num_decoder_layers=6, dim_feedforward=2048, dropout=0.1, activation="relu", normalize_before=False):
        super().__init__()
        enc = TransformerEncoderLayer(d_model, nhead, dim_feedforward, dropout, activation, normalize_before=normalize_before)
        dec = TransformerDecoderLayer(d_model, nhead, dim_feedforward, dropout, activation, normalize_before)
        self.encoder = TransformerEncoder(enc, num_encoder_layers)
        self.decoder = TransformerDecoder(dec, num_decoder_layers)
        self.d_model = d_model
        self.nhead = nhead

    def forward(self, src, tgt, src_mask=None, tgt_mask=None, memory_mask=None):
        memory = self.encoder(src, src_mask=src_mask)
        return self.decoder(tgt, memory, tgt_mask=tgt_mask, memory_mask=memory_mask)
