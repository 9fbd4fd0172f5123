"""Device selection for the port's entry points.

Entry points run on the card unless the caller asks for the CPU. There is
no silent CPU fallback: asking for CUDA (or asking for nothing) on a
machine without it raises.
"""

from __future__ import annotations

from typing import Optional, Union

import torch


def resolve_device(device: Optional[Union[str, torch.device]] = None) -> torch.device:
    """``None`` means ``cuda``. Returns a ``torch.device``; raises
    ``RuntimeError`` when CUDA is asked for (explicitly or by default)
    and unavailable, ``ValueError`` for a device type the port does not
    run on."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError(
                "CUDA is not available; pass device='cpu' to run the port's "
                "plain PyTorch path on the CPU"
            )
        if dev.index is None:
            dev = torch.device("cuda", torch.cuda.current_device())
        return dev
    if dev.type == "cpu":
        return dev
    raise ValueError(f"unsupported device {dev} (use 'cuda' or 'cpu')")
