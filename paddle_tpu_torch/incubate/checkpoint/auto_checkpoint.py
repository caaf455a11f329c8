"""Auto-checkpoint: epoch-loop snapshots + restart resume.

Port of ``paddle_tpu/incubate/checkpoint/auto_checkpoint.py`` (the text
is the JAX package's; the snapshot goes through the port's
``static/io.py``, which loads into the scope's tensors in place where
it can, so a replayed step stays captured).

Counterpart of Paddle's python/paddle/fluid/incubate/checkpoint/
auto_checkpoint.py (AutoCheckpointChecker, ExeTrainStatus,
train_epoch_range): Paddle wraps the user's epoch loop,
periodically snapshots executor+program state to HDFS, and on job restart
(PaddleCloud relaunches the pod) fast-forwards to the recorded epoch.

Here the snapshot is the scope's persistables (static.io
save/load_persistables) plus a JSON status file; the launcher's
relaunch plays PaddleCloud's role, and PADDLE_RESTART_COUNT tells the
wrapped loop it is a resume run. Local filesystem by default
(PADDLE_CHECKPOINT_DIR); a job points it at a shared filesystem the way
Paddle points at HDFS.
"""
from __future__ import annotations

import json
import os
import shutil
import time
from typing import Optional

_CKPT_ENV = "PADDLE_CHECKPOINT_DIR"


class TrainEpochRange:
    """`for epoch in TrainEpochRange(n, name, exe=..., program=..., scope=...):`
    — yields the epochs still to run; saves a snapshot after each epoch
    (save_interval) and resumes past completed epochs after a restart."""

    def __init__(self, max_epoch_num: int, name: str,
                 checkpoint_dir: Optional[str] = None,
                 exe=None, program=None, scope=None,
                 save_interval: int = 1, resume: Optional[bool] = None):
        self.max_epoch_num = int(max_epoch_num)
        self.name = name
        self.dir = checkpoint_dir or os.environ.get(_CKPT_ENV, ".paddle_ckpt")
        self.exe = exe
        self.program = program
        self.scope = scope
        self.save_interval = max(int(save_interval), 1)
        # resume gate: only a RELAUNCHED job (PADDLE_RESTART_COUNT > 0, set
        # by the elastic launcher) fast-forwards by default — a fresh run
        # that happens to share the checkpoint dir must not silently skip
        # its epochs; resume=True forces (manual restarts)
        if resume is None:
            resume = int(os.environ.get("PADDLE_RESTART_COUNT", "0")) > 0
        self.resume = bool(resume)
        self._status_path = os.path.join(self.dir, name, "status.json")
        self._params_dir = os.path.join(self.dir, name, "params")

    # -- status ---------------------------------------------------------
    def _load_status(self):
        try:
            with open(self._status_path) as f:
                return json.load(f)
        except (OSError, ValueError):
            return None

    def _save_status(self, epoch: int):
        os.makedirs(os.path.dirname(self._status_path), exist_ok=True)
        tmp = self._status_path + ".tmp"
        with open(tmp, "w") as f:
            json.dump({"name": self.name, "epoch_no": epoch,
                       "ts": time.time()}, f)
        os.replace(tmp, self._status_path)

    # -- snapshot -------------------------------------------------------
    def _save_params(self):
        if self.exe is None or self.program is None:
            return
        from ...static import io as static_io

        tmp = self._params_dir + ".tmp"
        if os.path.isdir(tmp):
            shutil.rmtree(tmp)
        static_io.save_persistables(self.exe, tmp, self.program,
                                    scope=self.scope)
        if os.path.isdir(self._params_dir):
            shutil.rmtree(self._params_dir)
        os.replace(tmp, self._params_dir)

    def _restore_params(self):
        if self.exe is None or self.program is None:
            return
        from ...static import io as static_io

        if os.path.isdir(self._params_dir):
            static_io.load_persistables(self.exe, self._params_dir,
                                        self.program, scope=self.scope)

    # -- the epoch loop -------------------------------------------------
    def __iter__(self):
        start = 0
        status = self._load_status() if self.resume else None
        if status is not None:
            # a restart: resume AFTER the last fully-saved epoch
            start = int(status["epoch_no"]) + 1
            self._restore_params()
        for epoch in range(start, self.max_epoch_num):
            yield epoch
            if (epoch + 1) % self.save_interval == 0 or epoch == self.max_epoch_num - 1:
                self._save_params()
                self._save_status(epoch)

    def restored_from(self) -> Optional[int]:
        s = self._load_status()
        return None if s is None else int(s["epoch_no"])


def train_epoch_range(max_epoch_num: int, name: str = "default", **kw):
    """Paddle's auto_checkpoint.train_epoch_range, the generator form."""
    yield from TrainEpochRange(max_epoch_num, name, **kw)
