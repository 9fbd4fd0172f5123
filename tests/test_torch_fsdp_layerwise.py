"""FSDP one layer at a time: the port's ``make_fsdp_train_step`` over a
gloo world of 2 ranks (``data = 2``) against the JAX package.

A params tree with a ``layers`` list is gathered leaf by leaf where the
forward reads it, and gathered again for the backward, so a rank never
holds more gathered bytes at once than the largest of the head, the
embedding and one layer's gathered leaves; a tree without ``layers``
(the MLP) is gathered whole, as before.

float32 TINY, params from the JAX package's init through numpy, the
tolerances of ``test_fsdp_lm_step_matches_the_single_device_reference``
(``test_torch_parallel_tp``): each loss within ``1e-5`` relative, each
leaf's update within ``1e-4`` of the reference's largest change of that
leaf or one float32 ulp of the leaf. SGD: an Adam step moves an element
whose gradient is float32 noise by a different fraction of lr.
"""

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest

from devspace_tpu.models import transformer as jtfm
from devspace_tpu.training import trainer as jtrainer
import torch_parallel_workers as w
from test_torch_parallel_tp import LOSS_RTOL, TINY32, assert_updates_close, np_tree
from torch_parallel_world import World

STEPS, LR = 2, 1e-2


@pytest.fixture(scope="module")
def world(tmp_path_factory):
    wd = World(2, tmp_path_factory.mktemp("gloo"))
    yield wd
    wd.close()


@pytest.fixture(scope="module")
def case():
    """The weights, tokens, and the JAX package's single-device SGD steps:
    the losses and the params after."""
    cfg = jtfm.TransformerConfig(**TINY32, dtype=jnp.float32)
    params = np_tree(jtfm.init_params(cfg, jax.random.PRNGKey(3)))
    tokens = np.random.default_rng(5).integers(0, 256, size=(4, 33))
    opt = optax.sgd(LR)
    state = {"params": jax.tree.map(jnp.asarray, params), "step": jnp.zeros((), jnp.int32)}
    state["opt_state"] = opt.init(state["params"])
    step = jtrainer.make_lm_train_step(jtfm.forward, cfg, opt)
    losses = []
    for _ in range(STEPS):
        state, loss = step(state, jnp.asarray(tokens))
        losses.append(float(loss))
    return params, tokens, losses, np_tree(state["params"])


@pytest.fixture(scope="module", params=[False, True], ids=["plain", "remat"])
def steps(request, world, case):
    """Each rank's layer-by-layer FSDP steps, without and with remat."""
    params, tokens, _, _ = case
    return world.run(w.fsdp_layerwise_steps, params, TINY32, tokens, LR, STEPS, request.param)


def test_layerwise_steps_match_the_single_device_reference(case, steps):
    params, _, ref_losses, ref_params = case
    for r in steps:
        assert r["layerwise"]
        np.testing.assert_allclose(r["losses"], ref_losses, rtol=LOSS_RTOL)
        assert_updates_close(params, ref_params, r["params"])


def test_at_most_one_layer_or_the_head_is_gathered_at_once(steps):
    """The bound: the largest of the head, the embedding and one layer's
    gathered leaves (the replicated leaves are never gathered); the whole
    gathered model, which the step held before, is well above it."""
    for r in steps:
        b = r["bytes"]
        bound = max(b["embed"], b["lm_head"], *b["layers"])
        assert all(0 < peak <= bound for peak in r["peaks"]), (r["peaks"], bound)
        assert b["whole"] >= 2 * bound


def test_a_tree_without_layers_is_gathered_whole(world):
    """The tanh MLP of ``test_fsdp_step_matches_single_device``: its
    sharded leaves are all alive at once, as before, and one Adam(1e-2)
    step matches the JAX package's on one device (loss ``1e-5``
    relative, params ``rtol=1e-5, atol=1e-6``, that test's)."""
    rng = np.random.default_rng(0)
    params = {"w1": (rng.standard_normal((16, 64)) * 0.1).astype(np.float32),
              "w2": (rng.standard_normal((64, 4)) * 0.1).astype(np.float32),
              "b": np.zeros(4, np.float32)}
    xs = rng.standard_normal((32, 16)).astype(np.float32)
    ys = rng.standard_normal((32, 4)).astype(np.float32)

    def loss_fn(p, b):
        pred = jnp.tanh(b["x"] @ p["w1"]) @ p["w2"] + p["b"]
        return jnp.mean((pred - b["y"]) ** 2)

    opt, p = optax.adam(1e-2), jax.tree.map(jnp.asarray, params)
    loss, g = jax.value_and_grad(loss_fn)(p, {"x": xs, "y": ys})
    upd, _ = opt.update(g, opt.init(p), p)
    p = optax.apply_updates(p, upd)
    for r in world.run(w.fsdp_mlp_peak, params, xs, ys):
        assert not r["layerwise"]
        assert r["peak"] == r["whole"] == (16 * 64 + 64 * 4) * 4
        np.testing.assert_allclose(r["loss"], float(loss), rtol=LOSS_RTOL)
        for k in params:
            np.testing.assert_allclose(r["params"][k], np.asarray(p[k]), rtol=1e-5, atol=1e-6,
                                       err_msg=k)

