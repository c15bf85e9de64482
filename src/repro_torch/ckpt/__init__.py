"""Checkpointing: atomic save and restore (port of ``repro.ckpt``)."""

from . import manager, reshard
from .manager import CheckpointManager
from .reshard import mesh_axis_sizes, put_tree

__all__ = ["manager", "reshard", "CheckpointManager", "mesh_axis_sizes",
           "put_tree"]
