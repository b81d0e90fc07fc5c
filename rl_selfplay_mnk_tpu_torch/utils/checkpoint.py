"""Train-state checkpoints (counterpart of the JAX package's
``utils/checkpoint.py``, in a format of its own).

A checkpoint is one ``torch.save`` file a step, ``<dir>/step_<N>.pt``,
written to a temporary name and moved into place with ``os.replace``, so a
run cut during the write leaves the previous checkpoints whole. The newest
``max_to_keep`` (3) are kept. The state is any nest of dicts, lists and
tuples of tensors and plain Python values; it is read back with
``weights_only=True`` onto the CPU, and the caller moves what it needs.
"""

from __future__ import annotations

import os
import re
from typing import Any, Optional, Tuple

import torch

_NAME = re.compile(r"^step_(\d+)\.pt$")


def _steps(ckpt_dir: str) -> list:
    if not os.path.isdir(ckpt_dir):
        return []
    return sorted(int(m.group(1)) for f in os.listdir(ckpt_dir) if (m := _NAME.match(f)))


def _path(ckpt_dir: str, step: int) -> str:
    return os.path.join(ckpt_dir, f"step_{step}.pt")


def save_checkpoint(ckpt_dir: str, step: int, state: Any, max_to_keep: int = 3) -> str:
    """Write ``state`` as checkpoint ``step``; drop all but the newest
    ``max_to_keep``. Returns the file's path."""
    os.makedirs(ckpt_dir, exist_ok=True)
    path = _path(ckpt_dir, step)
    tmp = f"{path}.{os.getpid()}.tmp"
    torch.save(state, tmp)
    os.replace(tmp, path)
    for old in _steps(ckpt_dir)[:-max_to_keep]:
        os.remove(_path(ckpt_dir, old))
    return path


def latest_checkpoint_step(ckpt_dir: str) -> Optional[int]:
    steps = _steps(ckpt_dir)
    return steps[-1] if steps else None


def restore_checkpoint(ckpt_dir: str, step: Optional[int] = None) -> Tuple[Any, Optional[int]]:
    """The state saved at ``step`` (default: the newest) and its step, or
    (None, None) when there is none."""
    if step is None:
        step = latest_checkpoint_step(ckpt_dir)
    if step is None:
        return None, None
    return torch.load(_path(ckpt_dir, step), map_location="cpu", weights_only=True), step
