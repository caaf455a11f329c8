"""paddle.callbacks namespace: the fit loop's callbacks of
``hapi/model.py`` (port of ``paddle_tpu/callbacks.py``)."""
from .hapi.model import (Callback, EarlyStopping, LRScheduler,  # noqa: F401
                         LRSchedulerCallback, ModelCheckpoint, ProgBarLogger)
