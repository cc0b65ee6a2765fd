"""Checkpoint / resume (port of plnlp_tpu/checkpoint.py).

The JAX package keeps (params, opt_state, extra) with orbax.  Here a
checkpoint is one ``torch.save`` file ``<dir>/step_<n>.pt`` holding
``{"model": state_dict, "optimizer": state_dict, "extra": dict}``, read back
with ``torch.load(weights_only=True)``, so restoring runs no pickled code.
A save writes a temporary name and renames it over the final one
(``os.replace``), so a kill during a save leaves the last checkpoint whole;
only the newest ``max_to_keep`` are kept.
"""

from __future__ import annotations

import os
import re
from typing import Any, Dict, List, Optional, Tuple

import torch

__all__ = ["CheckpointManager"]

_NAME = re.compile(r"^step_(\d+)\.pt$")


class CheckpointManager:
    """Numbered checkpoints of the training state in one directory."""

    def __init__(self, directory: str, max_to_keep: int = 3):
        self.directory = os.path.abspath(directory)
        self.max_to_keep = max_to_keep
        os.makedirs(self.directory, exist_ok=True)

    def _path(self, step: int) -> str:
        return os.path.join(self.directory, f"step_{step}.pt")

    def all_steps(self) -> List[int]:
        """Steps on disk, oldest first."""
        steps = [int(m.group(1)) for m in map(_NAME.match, os.listdir(self.directory)) if m]
        return sorted(steps)

    def latest_step(self) -> Optional[int]:
        steps = self.all_steps()
        return steps[-1] if steps else None

    def save(
        self,
        step: int,
        model_state: Dict[str, torch.Tensor],
        optimizer_state: Dict[str, Any],
        extra: Optional[Dict[str, Any]] = None,
    ) -> None:
        """``extra``: plain data (run, epoch, the Logger's results...)."""
        path = self._path(step)
        tmp = f"{path}.tmp"
        torch.save({"model": model_state, "optimizer": optimizer_state, "extra": extra}, tmp)
        os.replace(tmp, path)
        for old in self.all_steps()[: -self.max_to_keep]:
            os.remove(self._path(old))

    def restore(
        self, step: Optional[int] = None, device=None
    ) -> Tuple[Dict[str, torch.Tensor], Dict[str, Any], Optional[Dict[str, Any]]]:
        """(model state_dict, optimizer state_dict, extra or None) of the
        latest (or ``step``) checkpoint, tensors mapped to ``device``."""
        if step is None:
            step = self.latest_step()
        if step is None:
            raise FileNotFoundError(f"no checkpoints under {self.directory}")
        ck = torch.load(self._path(step), map_location=device, weights_only=True)
        return ck["model"], ck["optimizer"], ck["extra"]
