"""Checkpoints in the reference's layout (``checkpoint/``): atomic saves of
nested dict / tuple trees, one ``.npy`` a leaf plus ``manifest.json``, a
background writer, and a manager with ``step_%08d`` rotation and resume."""

from .checkpointer import AsyncCheckpointer, load_checkpoint, save_checkpoint
from .manager import CheckpointManager
