"""Kernel dispatch: the CUDA kernel for CUDA tensors, the plain version
for CPU tensors.

Every op in this package has two implementations with the same
semantics: a kernel written by hand for Hopper (``csrc/``) and a plain
PyTorch version (the CPU path, and what the kernel is held against on
the card). The choice follows the tensors' device and nothing else — no
environment switch, no ``try``/``except`` that falls back: a CUDA tensor
either launches the kernel or raises.
"""

from __future__ import annotations

import torch


def on_cuda(*tensors: torch.Tensor) -> bool:
    """True when every tensor lies on a CUDA device, False when every one
    lies on the CPU, or every one on the meta device (shapes without data:
    the plain version traces them, as ``lint.rules_sharding`` runs a
    function to read its output shapes); raises for a mix or any other
    device."""
    types = {t.device.type for t in tensors}
    if types == {"cuda"}:
        if len({t.device for t in tensors}) != 1:
            raise ValueError("tensors lie on different CUDA devices")
        return True
    if types in ({"cpu"}, {"meta"}):
        return False
    raise ValueError(
        f"tensors must all lie on one CUDA device or all on the CPU (or all "
        f"on the meta device), got {sorted(str(t.device) for t in tensors)}"
    )
