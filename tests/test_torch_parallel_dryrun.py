"""The composed steps of ``__graft_entry__.dryrun_multichip``, the port
over a gloo world of 8 ranks against the JAX package's step on its
8-device CPU mesh:

- the TINY LM (float32) trained one SGD(1e-3) step on ``{"data": 2,
  "model": 2, "seq": 2}`` (batch over ``data``, heads, FFN and the LM
  head over ``model``, the sequence over ``seq``) with ring attention and
  the vocab-parallel loss, tokens ``(4, 33)``; Ulysses in ring's place
  too;
- pp x dp x tp: the 1F1B step (TINY with 2 layers) and the interleaved
  step (4 layers, V = 2) on ``{"pipe": 2, "data": 2, "model": 2}``, 4
  microbatches of 4 rows (2 a ``data`` rank) by 17 tokens, one SGD(1e-3)
  step, each also within ``1e-5`` of the non-pipelined loss on the same
  tokens (the dryrun holds it to ``1e-3``).

Tolerances: the loss within ``1e-5`` relative; each leaf's gradient
within ``1e-4`` of the reference's largest value of that leaf (the SGD
update is ``-lr`` times it); each leaf's update within ``1e-4`` of the
reference's largest change of that leaf, or one float32 ulp of the leaf
(``test_torch_parallel_tp.assert_updates_close``).
"""

import os
import re
import subprocess
import sys
from pathlib import Path

import jax
import numpy as np
import pytest

from devspace_tpu.models import transformer as jtfm
from devspace_tpu.ops.losses import fused_cross_entropy as jxent
from devspace_tpu.parallel import pipeline as jpipe
from devspace_tpu.parallel.mesh import create_mesh as jcreate_mesh
from devspace_tpu.parallel.ring_attention import ring_attention as jring
from devspace_tpu.parallel.sequence_parallel import ulysses_attention as julysses
import jax.numpy as jnp
import optax
from jax.sharding import NamedSharding, PartitionSpec as JP
import torch_parallel_workers as w
from test_torch_parallel_tp import (
    TINY32,
    assert_grads_close,
    assert_updates_close,
    jax_lm_steps,
    np_tree,
)
from torch_parallel_world import World

AXES = {"data": 2, "model": 2, "seq": 2}
PIPE_AXES = {"pipe": 2, "data": 2, "model": 2}
REPO = Path(__file__).resolve().parent.parent
LONGCTX_TINY = {"LONGCTX_SEQ_LEN": "256", "LONGCTX_DIM": "64", "LONGCTX_LAYERS": "2",
                "LONGCTX_HEADS": "4", "LONGCTX_KV_HEADS": "2", "LONGCTX_FFN": "128",
                "LONGCTX_VOCAB": "256", "LONGCTX_STEPS": "11", "OMP_NUM_THREADS": "1"}
REFERENCE_ATTENTION = {
    "ring": lambda mesh: jring(mesh, axis="seq", causal=True, batch_axis="data"),
    "ulysses": lambda mesh: julysses(mesh, axis="seq", causal=True, batch_axis="data"),
}


@pytest.fixture(scope="module")
def world(tmp_path_factory):
    wd = World(8, tmp_path_factory.mktemp("gloo"))
    yield wd
    wd.close()


@pytest.mark.parametrize("attention", ["ring", "ulysses"])
def test_composed_dp_tp_sp_step_matches_the_reference(world, attention):
    jcfg = jtfm.TransformerConfig(**TINY32, dtype=jnp.float32)
    params = np_tree(jtfm.init_params(jcfg, jax.random.PRNGKey(0)))
    tokens = np.asarray(jax.random.randint(jax.random.PRNGKey(1), (4, 33), 0, 256))
    ref_losses, ref_params, ref_grads = jax_lm_steps(
        AXES, params, tokens, 1, 1e-3, "model", attention=REFERENCE_ATTENTION[attention])
    got = world.run(w.lm_mesh_step, AXES, params, TINY32, tokens, 1, 1e-3, True, attention)
    assert len(got) == 8
    for r in got:
        np.testing.assert_allclose(r["losses"], ref_losses, rtol=1e-5)
        assert np.isfinite(r["losses"]).all()
        assert_grads_close(ref_grads, r["grads"])
        assert_updates_close(params, ref_params, r["params"])


def dryrun_pipeline_step(n_chunks: int):
    """The dryrun's pipeline block (``__graft_entry__.py``): params, tokens,
    the non-pipelined loss and the JAX step's loss and params after one
    SGD(1e-3) step on the 8-device mesh."""
    n_layers = 2 * (n_chunks or 1)
    cfg = jtfm.TransformerConfig(**{**TINY32, "n_layers": n_layers}, dtype=jnp.float32)
    params = np_tree(jtfm.init_params(cfg, jax.random.PRNGKey(8 if n_chunks else 5)))
    tokens = np.asarray(jax.random.randint(jax.random.PRNGKey(6), (4, 4, 17), 0, 256))
    flat = tokens.reshape(16, 17)
    logits = jtfm.forward(params, flat[:, :-1], cfg)
    flat_loss = float(jnp.mean(jxent(logits.reshape(-1, 256), flat[:, 1:].reshape(-1))))
    mesh = jcreate_mesh(PIPE_AXES)
    if n_chunks:
        staged = jpipe.transformer_interleaved_stage_params(params, 2, n_chunks)
        specs = jpipe.interleaved_param_specs("pipe", tp_axis="model")
    else:
        staged = jpipe.transformer_stage_params(params, 2)
        specs = jpipe.pipeline_param_specs("pipe", tp_axis="model")
    placed = jax.tree_util.tree_map(lambda p, s: jax.device_put(p, NamedSharding(mesh, s)),
                                    staged, specs, is_leaf=lambda x: isinstance(x, JP))
    opt = optax.sgd(1e-3)
    if n_chunks:
        step = jpipe.make_interleaved_pipeline_lm_train_step(
            mesh, cfg, opt, 4, n_chunks, data_axis="data", tp_axis="model", donate=False)
    else:
        step = jpipe.make_pipeline_lm_train_step(mesh, cfg, opt, 4, data_axis="data",
                                                 tp_axis="model", donate=False)
    state = {"params": placed, "opt_state": opt.init(placed), "step": jnp.zeros((), jnp.int32)}
    state, loss = step(state, jax.device_put(tokens, NamedSharding(mesh, JP(None, "data"))))
    return {"cfg": {**TINY32, "n_layers": n_layers}, "params": params, "staged": np_tree(staged),
            "tokens": tokens, "flat_loss": flat_loss, "loss": float(loss),
            "after": np_tree(state["params"])}


@pytest.mark.parametrize("n_chunks", [0, 2], ids=["1f1b", "interleaved"])
def test_pp_dp_tp_step_matches_the_dryrun(world, n_chunks):
    ref = dryrun_pipeline_step(n_chunks)
    assert abs(ref["loss"] - ref["flat_loss"]) <= 1e-5 * abs(ref["flat_loss"])
    got = world.run(w.pipeline_train_steps, PIPE_AXES, ref["params"], ref["cfg"], ref["tokens"],
                    1, 1e-3, n_chunks, "cpu", 0.0, timeout=180.0)
    for r in got:
        np.testing.assert_allclose(r["losses"], [ref["loss"]], rtol=1e-5)
        assert_updates_close(ref["staged"], ref["after"], r["params"])


def test_long_context_script_under_torchrun_equals_one_process(tmp_path):
    """scripts/train_long_context_torch.py at the example's smoke sizes:
    one process (a ring of 1), and two launched by ``torchrun`` (a ring
    of 2 over gloo, rendezvous on this host): the same step-10 loss."""
    script = str(REPO / "scripts" / "train_long_context_torch.py")
    env = {**os.environ, **LONGCTX_TINY}
    runs = {
        1: [sys.executable, script, "--device", "cpu"],
        2: [sys.executable, "-m", "torch.distributed.run", "--standalone", "--nproc-per-node",
            "2", script, "--device", "cpu"],
    }
    losses = {}
    for n, cmd in runs.items():
        out = subprocess.run(cmd, cwd=tmp_path, env=env, capture_output=True, text=True,
                             timeout=240)
        assert out.returncode == 0, out.stderr[-3000:]
        assert f"ring of {n}" in out.stdout and out.stdout.rstrip().endswith("done")
        losses[n] = float(re.search(r"step   10 loss (\S+)", out.stdout).group(1))
    assert losses[1] == losses[2]
