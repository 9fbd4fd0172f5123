"""Expert parallelism and FSDP of the port over a gloo world of 4 ranks,
against the JAX package.

float32, inputs from numpy seeds, params carried across by
``models/convert.py``. Tolerances: MoE outputs ``rtol=1e-5,
atol=1e-6`` with routing and drops identical (the dropped tokens are
the reference's: capacity per rank, as its ``moe_ffn``); losses within
``1e-5`` relative; each leaf's gradient within ``1e-4`` of the
reference's largest value of that leaf, and its update within ``1e-4``
of the reference's largest change, or one float32 ulp of the leaf
(``test_torch_parallel_tp.assert_grads_close``, ``assert_updates_close``).
"""

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
from jax.sharding import NamedSharding, PartitionSpec as JP

from devspace_tpu.models import moe as jmoe
from devspace_tpu.models import transformer as jtfm
from devspace_tpu.ops.losses import fused_cross_entropy as jxent
from devspace_tpu.parallel import expert_parallel as jep
from devspace_tpu.parallel import fsdp as jfsdp
from devspace_tpu.parallel.mesh import create_mesh as jcreate_mesh
from devspace_tpu.training import trainer as jtrainer
from devspace_tpu_torch.models import moe as tmoe
from devspace_tpu_torch.parallel import expert_parallel as tep
from devspace_tpu_torch.parallel import fsdp as tfsdp
from devspace_tpu_torch.parallel.mesh import P
import torch_parallel_workers as w
from test_torch_parallel_tp import TINY32, assert_grads_close, assert_updates_close, np_tree
from torch_parallel_world import World

TOL = dict(rtol=1e-5, atol=1e-6)
EP_MOE = dict(vocab_size=128, dim=32, n_layers=2, n_heads=4, n_kv_heads=2, ffn_dim=64,
              num_experts=8, experts_per_token=2, capacity_factor=4.0, max_seq_len=64)


@pytest.fixture(scope="module")
def world(tmp_path_factory):
    wd = World(4, tmp_path_factory.mktemp("gloo"))
    yield wd
    wd.close()


def flat_specs(tree, leaf_type):
    flat = jax.tree_util.tree_flatten_with_path(tree, is_leaf=lambda s: isinstance(s, leaf_type))
    return [(jax.tree_util.keystr(p), tuple(s)) for p, s in flat[0]]


def test_moe_specs_equal_the_references():
    for axis in ("data", "expert"):
        assert flat_specs(tep.moe_param_spec(axis), P) == flat_specs(jep.moe_param_spec(axis), JP)
    for model_axis, expert_axis in (("model", "data"), (None, "data"), ("model", None)):
        ref = jmoe.param_partition_spec(jmoe.TINY_MOE, model_axis=model_axis,
                                        expert_axis=expert_axis)
        got = tmoe.param_partition_spec(tmoe.TINY_MOE, model_axis=model_axis,
                                        expert_axis=expert_axis)
        assert flat_specs(got, P) == flat_specs(ref, JP)


def test_moe_ffn_matches_the_dense_reference(world):
    """Ample capacity (no drops): dispatch and combine round-trip every
    token exactly, as the reference's test holds its own ``moe_ffn``."""
    t, d, f, e = 64, 16, 32, 8
    params = np_tree(jep.init_moe_params(jax.random.PRNGKey(0), d, f, e, dtype=jnp.float32))
    x = np.asarray(jax.random.normal(jax.random.PRNGKey(1), (t, d), jnp.float32))
    y_ref, _ = jep.moe_ffn_reference(jnp.asarray(x), params, k=1, capacity_factor=float(e))
    for r in world.run(w.moe_ffn_case, params, x, 1, float(e), "gelu"):
        np.testing.assert_allclose(r["y"], np.asarray(y_ref), **TOL)
        assert np.isfinite(r["aux"])


def test_moe_ffn_drops_what_the_reference_moe_ffn_drops(world):
    """Top-2 SwiGLU experts at a tight capacity on the reference's own
    4-device mesh: the same tokens lose the same choices (zero rows and
    partial combines equal), and the aux loss is the mean over ranks."""
    t, d, f, e = 64, 16, 32, 8
    params = np_tree(jep.init_moe_params(jax.random.PRNGKey(2), d, 2 * f, e, dtype=jnp.float32))
    params["w_down"] = np.asarray(
        jax.random.normal(jax.random.PRNGKey(5), (e, f, d), jnp.float32) * 0.02)
    params["w_gate"] = params["w_gate"] * 50.0  # peaky routing
    x = np.asarray(jax.random.normal(jax.random.PRNGKey(3), (t, d), jnp.float32))
    mesh = jcreate_mesh({"data": 4}, devices=jax.devices()[:4])
    layer = jep.moe_ffn(mesh, k=2, capacity_factor=0.5, activation=jep.swiglu)
    y_ref, aux_ref = layer(jax.device_put(x, NamedSharding(mesh, JP("data", None))),
                           jep.shard_moe_params(params, mesh))
    y_ref = np.asarray(y_ref)
    dropped = np.all(y_ref == 0.0, axis=1)
    assert dropped.any() and not dropped.all(), "the capacity should drop some tokens"
    for r in world.run(w.moe_ffn_case, params, x, 2, 0.5, "swiglu"):
        np.testing.assert_array_equal(np.all(r["y"] == 0.0, axis=1), dropped)
        np.testing.assert_allclose(r["y"], y_ref, **TOL)
        np.testing.assert_allclose(r["aux"], float(aux_ref), rtol=1e-5)


def jax_moe_ep_step(params, tokens, lr):
    cfg = jmoe.MoEConfig(**EP_MOE, dtype=jnp.float32)
    mesh = jcreate_mesh({"data": 4}, devices=jax.devices()[:4])
    spec = jmoe.param_partition_spec(cfg, model_axis=None, expert_axis="data")
    fresh = jax.tree.map(jnp.asarray, params)
    opt = optax.sgd(lr)
    state = {"params": jax.tree_util.tree_map(
        lambda p, s: jax.device_put(p, NamedSharding(mesh, s)), fresh, spec,
        is_leaf=lambda x: isinstance(x, JP)),
        "opt_state": opt.init(fresh), "step": jnp.zeros((), jnp.int32)}
    moe_fn = jep.moe_ffn(mesh, axis="data", k=cfg.experts_per_token,
                         capacity_factor=cfg.capacity_factor, activation=jep.swiglu)
    step = jtrainer.make_moe_lm_train_step(jmoe.forward, cfg, opt, mesh=mesh, param_spec=spec,
                                           moe_fn=moe_fn)

    def loss_fn(p, tok):  # the reference trainer's MoE loss (training/trainer.py:248)
        logits, aux = jmoe.forward(p, tok[:, :-1], cfg, moe_fn=moe_fn)
        b, t, v = logits.shape
        ce = jnp.mean(jxent(logits.reshape(b * t, v), tok[:, 1:].reshape(-1)))
        return ce + cfg.aux_weight * aux

    grads = np_tree(jax.jit(jax.grad(loss_fn))(state["params"], jnp.asarray(tokens)))
    state, metrics = step(state, jnp.asarray(tokens))
    return {k: float(v) for k, v in metrics.items()}, np_tree(state["params"]), grads


def test_moe_lm_step_with_experts_over_data_matches_the_reference(world):
    """The dryrun's MoE part at 4 ranks: experts sharded over ``data``,
    top-2 SwiGLU routing by all-to-all, one SGD(1e-3) step."""
    cfg = jmoe.MoEConfig(**EP_MOE, dtype=jnp.float32)
    params = np_tree(jmoe.init_params(cfg, jax.random.PRNGKey(2)))
    tokens = np.asarray(jax.random.randint(jax.random.PRNGKey(3), (4, 17), 0, 128))
    ref_metrics, ref_params, ref_grads = jax_moe_ep_step(params, tokens, 1e-3)
    for r in world.run(w.moe_mesh_step, params, EP_MOE, tokens, 1e-3):
        for name in ("loss", "ce", "aux"):
            np.testing.assert_allclose(r["metrics"][name], ref_metrics[name], rtol=1e-5)
        assert_grads_close(ref_grads, r["grads"])
        assert_updates_close(params, ref_params, r["params"])
    for msg in world.run(w.moe_dense_refused, EP_MOE):
        assert "moe_fn" in msg


@pytest.mark.parametrize("shape", [(), (4,), (16, 64), (64, 4), (64, 64), (3, 1024), (6, 6, 32),
                                   (1024,), (8, 1023)])
@pytest.mark.parametrize("min_size", [64, 1024])
def test_fsdp_leaf_spec_is_the_references(shape, min_size):
    for n in (2, 4, 8):
        ref = jfsdp.fsdp_leaf_spec(shape, "data", n, min_size)
        assert tuple(tfsdp.fsdp_leaf_spec(shape, "data", n, min_size)) == tuple(ref)


def test_fsdp_step_matches_single_device(world):
    """The reference's FSDP test: two Adam(1e-2) steps of a tanh MLP,
    params and moments sharded (min_size 64), against one device."""
    rng = np.random.default_rng(0)
    params = {"w1": (rng.standard_normal((16, 64)) * 0.1).astype(np.float32),
              "w2": (rng.standard_normal((64, 4)) * 0.1).astype(np.float32),
              "b": np.zeros(4, np.float32)}
    xs = rng.standard_normal((32, 16)).astype(np.float32)
    ys = rng.standard_normal((32, 4)).astype(np.float32)

    def loss_fn(p, b):
        pred = jnp.tanh(b["x"] @ p["w1"]) @ p["w2"] + p["b"]
        return jnp.mean((pred - b["y"]) ** 2)

    opt = optax.adam(1e-2)
    p, s, losses = jax.tree.map(jnp.asarray, params), None, []
    s = opt.init(p)
    for _ in range(2):
        loss, g = jax.value_and_grad(loss_fn)(p, {"x": xs, "y": ys})
        upd, s = opt.update(g, s, p)
        p = optax.apply_updates(p, upd)
        losses.append(float(loss))
    for r in world.run(w.fsdp_case, params, xs, ys, 1e-2, 64, 2):
        assert r["spec"] == {"w1": P(None, "data"), "w2": P("data", None), "b": P()}
        assert r["shapes"] == {"w1": (16, 16), "w2": (16, 4), "b": (4,)}
        # moments live on the shards with their params' specs
        opt_spec = dict(zip(sorted(params), r["opt_spec"]))
        assert opt_spec["w1"]["exp_avg"] == P(None, "data") and opt_spec["b"]["step"] == P()
        np.testing.assert_allclose(r["losses"], losses, rtol=1e-5)
        for k in params:
            np.testing.assert_allclose(r["params"][k], np.asarray(p[k]), **TOL, err_msg=k)


def test_fsdp_lm_step_matches_the_single_device_reference(world):
    """The TINY LM (float32) through ``make_fsdp_train_step``, one
    SGD(1e-2) step: the leaves of 1024 elements or more sharded over
    ``data``, against the JAX package's single-device step. (SGD: an
    Adam step moves an element whose gradient is float32 noise by a
    different fraction of lr, test_torch_trainer.py.)"""
    jcfg = jtfm.TransformerConfig(**TINY32, dtype=jnp.float32)
    params = np_tree(jtfm.init_params(jcfg, jax.random.PRNGKey(0)))
    tokens = np.random.default_rng(1).integers(0, 256, size=(4, 33))
    opt = optax.sgd(1e-2)
    state = {"params": jax.tree.map(jnp.asarray, params), "step": jnp.zeros((), jnp.int32)}
    state["opt_state"] = opt.init(state["params"])

    def loss_fn(p, tok):
        logits = jtfm.forward(p, tok[:, :-1], jcfg)
        b, t, v = logits.shape
        return jnp.mean(jxent(logits.reshape(b * t, v), tok[:, 1:].reshape(-1)))

    grads = np_tree(jax.grad(loss_fn)(state["params"], jnp.asarray(tokens)))
    step = jtrainer.make_lm_train_step(jtfm.forward, jcfg, opt)
    state, loss = step(state, jnp.asarray(tokens))
    ref = np_tree(state["params"])
    for r in world.run(w.fsdp_lm_step, params, TINY32, tokens, 1e-2):
        np.testing.assert_allclose(r["loss"], float(loss), rtol=1e-5)
        assert_grads_close(grads, r["grads"])
        assert_updates_close(params, ref, r["params"])
