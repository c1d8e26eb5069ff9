"""Checkpoint and resume, the counterpart of :mod:`dfgnn_tpu.utils.checkpoint`.

The JAX package saves (params, opt_state, step) with orbax under
``path/step_N``; the port saves a ``torch.save`` of ``state_dict``s there
(for example ``{"model": model.state_dict(), "opt": opt.state_dict()}``).
"""

from __future__ import annotations

import os
from typing import Any, Optional

import torch


def save_checkpoint(path: str, state: Any, step: int) -> str:
    """Writes ``state`` (nested dicts of tensors and plain values, such as
    ``state_dict``s) to ``path/step_<step>`` and returns that file's path."""
    path = os.path.abspath(path)
    os.makedirs(path, exist_ok=True)
    target = os.path.join(path, f"step_{step}")
    torch.save(state, target)
    return target


def restore_checkpoint(path: str, template: Any = None, step: Optional[int] = None):
    """Reads ``path/step_<step>`` (the latest step when ``step`` is None) and
    returns ``(state, step)``; tensors land on the devices they were saved
    from.  ``template`` is accepted for the JAX signature's sake: a
    ``state_dict`` needs none, and its ``load_state_dict`` checks the keys
    and shapes.  Raises ``FileNotFoundError`` when there is no checkpoint."""
    del template
    path = os.path.abspath(path)
    if step is None:
        steps = sorted(int(d.split("_")[1]) for d in os.listdir(path)
                       if d.startswith("step_") and d.split("_")[1].isdigit())
        if not steps:
            raise FileNotFoundError(f"no checkpoints under {path}")
        step = steps[-1]
    target = os.path.join(path, f"step_{step}")
    if not os.path.exists(target):
        raise FileNotFoundError(target)
    return torch.load(target, weights_only=True), step
