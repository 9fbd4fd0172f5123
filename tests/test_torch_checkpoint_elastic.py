"""Elastic restore of a whole train state, the port's counterpart of
``tests/test_training.py::test_elastic_restore_across_mesh_shapes``,
over a gloo world of 2 ranks.

A train state (params, AdamW moments, step) after one step is saved
from FSDP's ``{data: 2}`` or from the 1F1B step's ``{pipe: 2}``, and
restored with its moments through a train-state ``sharded_template`` at
``{model: 2}`` (the TP spec), at ``{data: 2}`` (FSDP's) and in one
process. float32 TINY, params from the JAX package's init, AdamW 1e-3.

- Each rank's moment blocks equal the saved logical moments cut by its
  parameter's spec, EXACTLY (a restore copies bytes); the restored step
  is the saved one.
- The next step's loss equals the uninterrupted run's within ``1e-5``
  relative (the same values, reduced in another order on another
  layout), and the JAX package's second AdamW step's within ``atol=1e-5``
  (``test_torch_trainer.py``'s loss tolerance).
"""

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from devspace_tpu.models import transformer as jtfm
from devspace_tpu.training import trainer as jtrainer
from devspace_tpu_torch.models import transformer as ttfm
from devspace_tpu_torch.models.convert import params_from_numpy
from devspace_tpu_torch.training import checkpoint as tckpt
from devspace_tpu_torch.training import trainer as ttrainer
import torch_parallel_workers as w
from test_torch_checkpoint_mesh import block
from test_torch_parallel_tp import LOSS_RTOL, TINY32, np_tree
from torch_parallel_world import World

LR = 1e-3
LOSS_ATOL = 1e-5
RUN_TIMEOUT = 180.0


@pytest.fixture(scope="module")
def world(tmp_path_factory):
    wd = World(2, tmp_path_factory.mktemp("gloo"))
    yield wd
    wd.close()


@pytest.fixture(scope="module")
def case():
    """Weights, tokens and the JAX package's second AdamW step's loss."""
    cfg = jtfm.TransformerConfig(**TINY32, dtype=jnp.float32)
    params = np_tree(jtfm.init_params(cfg, jax.random.PRNGKey(9)))
    tokens = np.random.default_rng(2).integers(0, 256, size=(4, 17))
    opt = optax.adamw(LR)
    state = {"params": jax.tree.map(jnp.asarray, params), "step": jnp.zeros((), jnp.int32)}
    state["opt_state"] = opt.init(state["params"])
    step = jtrainer.make_lm_train_step(jtfm.forward, cfg, opt)
    state, _ = step(state, jnp.asarray(tokens))
    _, loss2 = step(state, jnp.asarray(tokens))
    return params, tokens, float(loss2)


def flat_moments(moments: dict) -> dict:
    """Saved moments by name, a pipe save's ``stages.<leaf>`` ``[S, K, ...]``
    split into ``layers.<s * K + k>.<leaf>`` (its scalar ``step`` to each)."""
    out = {}
    for name, entry in moments.items():
        if not name.startswith("stages."):
            out[name] = entry
            continue
        leaf = name.removeprefix("stages.")
        s_n, k_n = entry["exp_avg"].shape[:2]
        for si in range(s_n):
            for ki in range(k_n):
                out[f"layers.{si * k_n + ki}.{leaf}"] = {
                    key: v if v.ndim == 0 else v[si, ki] for key, v in entry.items()}
    return out


@pytest.fixture(scope="module", params=["fsdp", "pipe"])
def saved(request, world, case, tmp_path_factory):
    params, tokens, _ = case
    root = str(tmp_path_factory.mktemp(f"elastic-{request.param}"))
    got = world.run(w.elastic_save, root, request.param, params, TINY32, tokens, LR,
                    timeout=RUN_TIMEOUT)
    assert got[0]["loss"] == got[1]["loss"]
    return (request.param, f"{root}/step_00000001", got[0]["loss"],
            flat_moments(got[0]["moments"]))


@pytest.mark.parametrize("axis", ["model", "data"])
def test_a_train_state_resumes_on_another_mesh_with_its_moments(world, case, saved, axis):
    _, tokens, jax_loss = case
    kind, path, uninterrupted, moments = saved
    got = world.run(w.elastic_restore, path, axis, TINY32, tokens, LR, timeout=RUN_TIMEOUT)
    assert sorted(r["index"] for r in got) == [0, 1]
    for r in got:
        assert r["step"] == 1
        assert sorted(r["moments"]) == sorted(moments)
        for name, entry in r["moments"].items():
            for key, value in entry.items():
                want = moments[name][key]
                if value.ndim:
                    want = block(want, r["specs"][name], r["index"])
                np.testing.assert_array_equal(value, want, err_msg=f"{kind} {name} {key}")
        np.testing.assert_allclose(r["loss"], uninterrupted, rtol=LOSS_RTOL)
        np.testing.assert_allclose(r["loss"], jax_loss, atol=LOSS_ATOL)


def test_a_train_state_resumes_in_one_process(case, saved):
    """Into ``init_train_state``'s optimizer, which has not stepped: the
    moments are bound whole by name (a pipe save's re-stacked to the
    flat tree), and the next step gives the same loss."""
    params_np, tokens, jax_loss = case
    kind, path, uninterrupted, moments = saved
    cfg = ttfm.TransformerConfig(**TINY32, dtype=torch.float32)
    state = ttrainer.init_train_state(params_from_numpy(params_np, "cpu", trainable=True),
                                      ttrainer.adamw(LR))
    state = tckpt.restore_checkpoint(path, state)
    assert state["step"] == 1
    names = tckpt.param_names(state["params"], state["opt_state"])
    assert sorted(names) == sorted(moments)
    held = [p for g in state["opt_state"].param_groups for p in g["params"]]
    for name, p in zip(names, held, strict=True):
        for key, value in state["opt_state"].state[p].items():
            np.testing.assert_array_equal(value.numpy(), moments[name][key], err_msg=name)
    step = ttrainer.make_lm_train_step(ttfm.forward, cfg, ttrainer.adamw(LR))
    _, loss = step(state, torch.from_numpy(tokens))
    np.testing.assert_allclose(loss.item(), uninterrupted, rtol=LOSS_RTOL)
    np.testing.assert_allclose(loss.item(), jax_loss, atol=LOSS_ATOL)


def test_a_train_state_template_needs_an_optimizer_factory(case):
    cfg = ttfm.TransformerConfig(**TINY32, dtype=torch.float32)
    logical = ttfm.init_params(cfg, torch.Generator(), device="meta")
    opt = ttrainer.adamw(LR)([torch.zeros(2, requires_grad=True)])
    with pytest.raises(ValueError, match="factory"):
        tckpt.sharded_template({"params": logical, "opt_state": opt, "step": 0}, None)
