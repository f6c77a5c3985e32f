"""Checkpoint manager: rotation and resume (the reference's
``checkpoint/manager.py``); ``restore(shardings=)`` is the elastic reshard
onto another mesh."""

from __future__ import annotations

import os
import re
import shutil
from typing import Any, Dict, List, Optional, Tuple

from repro_torch import Device

from .checkpointer import AsyncCheckpointer, load_checkpoint, save_checkpoint

_STEP_RE = re.compile(r"^step_(\d+)$")


class CheckpointManager:
    def __init__(self, directory: str, keep: int = 3, async_save: bool = True):
        self.directory = directory
        self.keep = keep
        os.makedirs(directory, exist_ok=True)
        self._async = AsyncCheckpointer() if async_save else None

    # ---------------------------------------------------------------- paths

    def _step_path(self, step: int) -> str:
        return os.path.join(self.directory, f"step_{step:08d}")

    def all_steps(self) -> List[int]:
        steps = []
        for name in os.listdir(self.directory):
            m = _STEP_RE.match(name)
            if m:
                steps.append(int(m.group(1)))
        return sorted(steps)

    def latest_step(self) -> Optional[int]:
        steps = self.all_steps()
        return steps[-1] if steps else None

    # ----------------------------------------------------------------- save

    def save(self, step: int, tree, extra: Optional[Dict] = None, block: bool = False):
        path = self._step_path(step)
        if self._async is not None and not block:
            self._async.save(path, tree, extra)
        else:
            if self._async is not None:
                self._async.wait()
            save_checkpoint(path, tree, extra)
        self._rotate()

    def _rotate(self):
        steps = self.all_steps()
        for s in steps[: -self.keep] if self.keep > 0 else []:
            shutil.rmtree(self._step_path(s), ignore_errors=True)

    def wait(self):
        if self._async is not None:
            self._async.wait()

    # -------------------------------------------------------------- restore

    def restore(self, step: Optional[int] = None, device: Device = None,
                shardings=None) -> Tuple[Any, Dict, int]:
        """Returns (tree, extra, step), the latest step by default, its
        leaves on ``device``.  ``shardings`` may target another mesh than the
        one that saved (elastic rescale): each rank reads its slices
        (``load_checkpoint``)."""
        self.wait()
        if step is None:
            step = self.latest_step()
            if step is None:
                raise FileNotFoundError(f"no checkpoints in {self.directory}")
        tree, extra = load_checkpoint(self._step_path(step), device, shardings)
        return tree, extra, step
