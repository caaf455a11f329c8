"""GPT decoder LM configuration.

Port of ``GPTConfig`` from ``paddle_tpu/models/gpt.py``. The static
training-program builders of that module belong to the training slice
and are not ported yet; serving (``serving/model.py``) reads only the
config. The fields are the JAX package's, so one set of keyword
arguments builds the same model in either package.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Optional

__all__ = ["GPTConfig"]


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
    # training-program options of the JAX package, kept so a config
    # round-trips between the packages; serving reads none of them
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
