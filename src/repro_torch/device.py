"""Explicit device resolution for the port.

Every entry point that touches a device takes it as an argument: ``"cuda"``
(the default everywhere) or ``"cpu"``, which a caller must ask for.  A
CUDA request on a host without a usable card raises instead of quietly
running on the CPU.  ``"meta"`` holds shapes and no data: the dry-run
traces the model on it (``launch.dryrun``), and weights are never drawn
there.  Nothing here runs at import time.
"""

from __future__ import annotations

import torch

__all__ = ["DEFAULT_DEVICE", "resolve"]

DEFAULT_DEVICE = "cuda"


def resolve(device: str | torch.device | None = None) -> torch.device:
    """``torch.device`` for ``device`` (None means ``"cuda"``).  Raises
    ``RuntimeError`` for a CUDA device when ``torch.cuda.is_available()`` is
    false, and ``ValueError`` for any type other than cuda, cpu or meta."""
    dev = torch.device(DEFAULT_DEVICE if device is None else device)
    if dev.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError(f"device {str(dev)!r} was asked for, but torch.cuda.is_available() is false")
        if dev.index is None:
            dev = torch.device("cuda", torch.cuda.current_device())
        return dev
    if dev.type in ("cpu", "meta"):
        return dev
    raise ValueError(f"unsupported device {str(dev)!r}: expected 'cuda', 'cuda:N', 'cpu' or 'meta'")
