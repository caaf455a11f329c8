"""Optimizers of the port (mirrors ``paddle_tpu/optimizer``)."""
from . import lr
from .optimizer import SGD, Adam, AdamW, Optimizer

__all__ = ["lr", "SGD", "Adam", "AdamW", "Optimizer"]
