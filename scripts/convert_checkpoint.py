"""Convert a checkpoint between the JAX package's Orbax format and the
PyTorch port's format (``devspace_tpu_torch/training/checkpoint.py``).

    python scripts/convert_checkpoint.py --to torch SRC DST [--step N]
    python scripts/convert_checkpoint.py --to orbax SRC DST [--step N]

The seam between the two packages: it needs jax and orbax, so it runs
where they are installed, never on the GPU machine, which then reads
the port's format with torch alone. ``SRC`` is a training root of
``step_NNNNNNNN`` dirs (the latest, or ``--step``, is converted) or one
checkpoint dir. Only the params cross: a train state's ``params`` are
taken and its optimizer state is left behind. With a step number the
result is written as ``DST/step_NNNNNNNN``, so ``DST`` serves as a root
(``CHECKPOINT=DST``, ``load_serving_params(DST)``); without one it is
``DST`` itself. Every leaf keeps its dtype and bytes (bf16 bit for bit).

- ``--to torch``: the Orbax checkpoint restored without a template,
  ``jax.tree.map(np.asarray)``, then written by the port's
  ``save_checkpoint`` as a bare params tree.
- ``--to orbax``: the port's checkpoint restored on the CPU, then
  written by the JAX package's ``save_checkpoint`` as a bare params tree
  that ``devspace_tpu.inference.load_serving_params`` accepts.
"""

from __future__ import annotations

import argparse
import os
import sys
from typing import Optional

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import jax
import jax.numpy as jnp
import numpy as np

from devspace_tpu.inference.checkpoint import _resolve_step_dir
from devspace_tpu.training import checkpoint as jax_ckpt
from devspace_tpu_torch.models.convert import params_from_numpy, params_to_numpy
from devspace_tpu_torch.training import checkpoint as torch_ckpt


def _dest(dst: str, step: Optional[int]) -> str:
    return os.path.join(dst, f"step_{step:08d}") if step is not None else dst


def orbax_to_torch(src: str, dst: str, step: Optional[int] = None) -> str:
    """Orbax checkpoint (train state or bare params) -> the port's bare
    params checkpoint; returns the directory written."""
    path, found = _resolve_step_dir(src, step)
    tree = jax_ckpt.restore_checkpoint(path)
    if isinstance(tree, dict) and "params" in tree:
        tree = tree["params"]
    params = params_from_numpy(jax.tree.map(np.asarray, tree), "cpu")
    out = _dest(dst, found)
    torch_ckpt.save_checkpoint(out, params)
    return out


def torch_to_orbax(src: str, dst: str, step: Optional[int] = None) -> str:
    """The port's checkpoint (train state or bare params) -> an Orbax bare
    params checkpoint; returns the directory written."""
    path, found = _resolve_step_dir(src, step)
    state = torch_ckpt.restore_checkpoint(path)
    params = state["params"] if torch_ckpt.is_train_state(state) else state
    tree = jax.tree.map(jnp.asarray, params_to_numpy(params))
    out = _dest(dst, found)
    jax_ckpt.save_checkpoint(out, tree)
    return out


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--to", choices=["torch", "orbax"], required=True)
    ap.add_argument("src")
    ap.add_argument("dst")
    ap.add_argument("--step", type=int, default=None)
    args = ap.parse_args(argv)
    convert = orbax_to_torch if args.to == "torch" else torch_to_orbax
    print(convert(args.src, args.dst, args.step))


if __name__ == "__main__":
    main()
