"""Where the port builds its tensors.

Entry points take ``device="cuda"`` by default and run on the card; the
caller asks for the CPU by name (the tests do).  Without a card they raise
rather than build on the CPU.
"""

from __future__ import annotations

import torch


def resolve_device(device) -> torch.device:
    """``device`` as a :class:`torch.device`; raises for CUDA without a card."""
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            f"device {str(device)!r} needs a CUDA card and torch.cuda.is_available() "
            "is false; pass device='cpu' to run on the CPU")
    return dev


def synchronize(device) -> None:
    """Waits for ``device``'s work when it is a CUDA device (a no-op on the
    CPU, where work is done when the call returns)."""
    if torch.device(device).type == "cuda":
        torch.cuda.synchronize(device)
