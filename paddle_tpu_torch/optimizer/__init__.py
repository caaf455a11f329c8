"""Optimizers of the port (mirrors ``paddle_tpu/optimizer``)."""
from . import lr
from .optimizer import (SGD, Adadelta, Adagrad, Adam, Adamax, AdamW,
                        DGCMomentumOptimizer, Lamb, LarsMomentum, Momentum,
                        Optimizer, RMSProp)

__all__ = ["lr", "SGD", "Momentum", "Adagrad", "Adam", "AdamW", "Adamax",
           "RMSProp", "Adadelta", "Lamb", "LarsMomentum",
           "DGCMomentumOptimizer", "Optimizer"]
