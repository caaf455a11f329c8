"""High-level API (``Model.fit``): port of ``paddle_tpu/hapi``."""
from .model import (Callback, EarlyStopping, Input, LRScheduler,
                    LRSchedulerCallback, Model, ModelCheckpoint,
                    ProgBarLogger)
from .model_io import load, save
