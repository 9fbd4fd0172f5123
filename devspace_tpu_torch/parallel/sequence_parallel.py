"""Ulysses-style sequence parallelism: all-to-all head/sequence exchange.

Counterpart of ``devspace_tpu/parallel/sequence_parallel.py``, the
second long-context layout next to ring attention. Activations flow
sharded on the sequence (``[B, T/P, H, D]``); for attention an
all-to-all re-shards them to the whole sequence and ``H/P`` heads
(``[B, T, H/P, D]``), exact attention runs on each rank's heads, and a
second all-to-all restores the sequence sharding. Two collectives per
attention against ring's ``P`` hops. The all-to-alls are
``collectives.all_to_all`` (``all_to_all_single``, its own transpose).
"""

from __future__ import annotations

from typing import Callable, Optional

import torch

from .collectives import all_to_all
from .mesh import Mesh
from .ring_attention import full_attention


def _seq_to_heads(x: torch.Tensor, n: int, group) -> torch.Tensor:
    """[B, t, H, D] (this rank's sequence block) -> [B, n*t, H/n, D]
    (the whole sequence, this rank's head group)."""
    b, t, h, d = x.shape
    chunks = x.reshape(b, t, n, h // n, d).permute(2, 0, 1, 3, 4)  # [n, B, t, H/n, D]
    got = all_to_all(chunks, group)  # chunk j: sequence block j
    return got.permute(1, 0, 2, 3, 4).reshape(b, n * t, h // n, d)


def _heads_to_seq(x: torch.Tensor, n: int, group) -> torch.Tensor:
    """[B, T, H/n, D] -> [B, T/n, H, D]: the inverse of ``_seq_to_heads``."""
    b, tt, hl, d = x.shape
    chunks = x.reshape(b, n, tt // n, hl, d).permute(1, 0, 2, 3, 4)  # [n, B, t, H/n, D]
    got = all_to_all(chunks, group)  # chunk j: head group j
    return got.permute(1, 2, 0, 3, 4).reshape(b, tt // n, n * hl, d)


class UlyssesAttention:
    """``f(q, k, v) -> out`` on this rank's sequence block ``[B, T/P, H,
    D]``; ``seq_axis`` as ``RingAttention``'s."""

    def __init__(self, mesh: Mesh, axis: str, causal: bool, attend: Callable):
        self.mesh, self.seq_axis, self.causal, self.attend = mesh, axis, causal, attend

    def __call__(self, q, k, v):
        n = self.mesh.size(self.seq_axis)
        if q.shape[2] % n:
            raise ValueError(
                f"ulysses needs heads ({q.shape[2]}) divisible by the "
                f"'{self.seq_axis}' axis size ({n})"
            )
        group = self.mesh.group(self.seq_axis)
        out = self.attend(_seq_to_heads(q, n, group), _seq_to_heads(k, n, group),
                          _seq_to_heads(v, n, group), causal=self.causal)
        return _heads_to_seq(out, n, group)


def ulysses_attention(
    mesh: Mesh,
    axis: str = "seq",
    causal: bool = True,
    batch_axis: Optional[str] = None,
    attn_fn: Optional[Callable] = None,
) -> UlyssesAttention:
    """Build ``f(q, k, v) -> out`` with q/k/v ``[B, T, H, D]`` sharded on
    T over ``axis`` (each rank passes its block). H must divide by the
    axis size (``ValueError`` otherwise). ``attn_fn(q, k, v, causal)``
    defaults to exact ``full_attention``; the flash path
    (``models.transformer.default_attention``) fits long shapes.
    ``batch_axis`` is checked against the mesh: a rank's tensors hold
    only its rows already."""
    for name in (axis, batch_axis):
        if name is not None:
            mesh.size(name)
    return UlyssesAttention(mesh, axis, causal, attn_fn or full_attention)
