"""Tensor parallelism, the transformer's f/g hooks and the vocab-parallel
loss of the port over a gloo world of 4 ranks, against the JAX package.

The JAX side runs in the pytest process on the 8-device CPU mesh of
``conftest.py``; the port's side in ``torch_parallel_workers``. float32
throughout, inputs from numpy seeds, params carried across by
``models/convert.py``. Tolerances:
- outputs ``rtol=1e-5, atol=1e-6``; input and weight gradients, which
  sum over more terms, ``rtol=1e-4, atol=1e-6``;
- train steps: each loss within ``1e-5`` relative; each leaf's gradient
  of the last step (an SGD update is ``-lr`` times it) within ``1e-4`` of
  the reference's largest value of that leaf; each leaf's update (after
  - before) within ``1e-4`` of the reference's largest change of that
  leaf, or within one float32 ulp of the leaf's largest value where that
  is coarser (an update of 1e-6 on a weight of 0.02 is resolved to ~2e-9
  by the stored params themselves, as the gradient check is not).
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch
from jax.sharding import NamedSharding, PartitionSpec as JP

from devspace_tpu.models import transformer as jtfm
from devspace_tpu.ops.losses import cross_entropy_reference as jxent_ref
from devspace_tpu.ops.losses import fused_cross_entropy as jxent
from devspace_tpu.ops.losses import vocab_parallel_cross_entropy as jvp
from devspace_tpu.parallel.mesh import create_mesh as jcreate_mesh
from devspace_tpu.parallel.ring_attention import full_attention as jfull
from devspace_tpu.training import trainer as jtrainer
from devspace_tpu_torch.models import transformer as ttfm
from devspace_tpu_torch.parallel.mesh import P
from devspace_tpu_torch.training import trainer as ttrainer
import torch_parallel_workers as w
from torch_parallel_world import World

OUT = dict(rtol=1e-5, atol=1e-6)
GRAD = dict(rtol=1e-4, atol=1e-6)
LOSS_RTOL, UPDATE_REL = 1e-5, 1e-4
TINY32 = dict(vocab_size=256, dim=64, n_layers=2, n_heads=4, n_kv_heads=2, ffn_dim=128,
              max_seq_len=128)


@pytest.fixture(scope="module")
def world(tmp_path_factory):
    wd = World(4, tmp_path_factory.mktemp("gloo"))
    yield wd
    wd.close()


def normal(shape, seed, scale=1.0):
    return (np.random.default_rng(seed).standard_normal(shape) * scale).astype(np.float32)


def np_tree(tree):
    return jax.tree.map(np.asarray, tree)


def assert_updates_close(before, after_ref, after_got):
    """Each leaf's update within UPDATE_REL of the reference's largest, or
    one float32 ulp of the leaf's largest value."""
    flat_b = jax.tree_util.tree_flatten_with_path(before)[0]
    flat_r = jax.tree_util.tree_leaves(after_ref)
    flat_g = jax.tree_util.tree_leaves(after_got)
    assert len(flat_b) == len(flat_r) == len(flat_g)
    for (path, b), r, g in zip(flat_b, flat_r, flat_g):
        du_ref = np.asarray(r, np.float64) - np.asarray(b, np.float64)
        du_got = np.asarray(g, np.float64) - np.asarray(b, np.float64)
        tol = max(UPDATE_REL * np.abs(du_ref).max(),
                  np.spacing(np.float32(np.abs(np.asarray(r)).max())))
        assert np.abs(du_got - du_ref).max() <= tol, jax.tree_util.keystr(path)


def assert_grads_close(ref, got):
    """Each leaf within UPDATE_REL of the reference's largest value."""
    flat_r = jax.tree_util.tree_flatten_with_path(ref)[0]
    flat_g = jax.tree_util.tree_leaves(got)
    assert len(flat_r) == len(flat_g)
    for (path, r), g in zip(flat_r, flat_g):
        r = np.asarray(r, np.float64)
        err = np.abs(np.asarray(g, np.float64) - r).max()
        assert err <= UPDATE_REL * np.abs(r).max(), (jax.tree_util.keystr(path), err)


def test_tp_mlp_matches_dense_and_its_grad(world):
    d, f = 16, 64
    x, dy = normal((4, d), 0), normal((4, d), 3)
    w_up, w_down = normal((d, f), 1, d ** -0.5), normal((f, d), 2, f ** -0.5)
    fn = lambda x, a, b: jax.nn.gelu(x @ a) @ b
    y, vjp = jax.vjp(fn, x, w_up, w_down)
    dx, da, db = vjp(jnp.asarray(dy))
    for r in world.run(w.tp_mlp_case, x, w_up, w_down, dy):
        np.testing.assert_allclose(r["y"], np.asarray(y), **OUT)
        np.testing.assert_allclose(r["dx"], np.asarray(dx), **GRAD)
        np.testing.assert_allclose(r["dw_up"], np.asarray(da), **GRAD)
        np.testing.assert_allclose(r["dw_down"], np.asarray(db), **GRAD)


def test_tp_attention_projections_match_dense(world):
    d, h = 32, 8
    x = normal((2, 16, d), 0)
    ws = [normal((d, d), s, d ** -0.5) for s in (1, 2, 3, 4)]
    q, k, v = (jnp.asarray(x) @ wt for wt in ws[:3])
    split = lambda z: z.reshape(2, 16, h, d // h)
    ref = jfull(split(q), split(k), split(v), causal=True).reshape(2, 16, d) @ ws[3]
    for r in world.run(w.tp_attention_case, x, *ws, h):
        np.testing.assert_allclose(r, np.asarray(ref), **OUT)


def test_layer_apply_hooks_on_shards_match_the_reference_layer(world):
    """One layer at tp = 4 (8 heads, 4 KV heads: 2 and 1 a rank) with the
    f/g hooks against the JAX package's ``layer_apply`` on the whole
    weights: output, input gradient, every weight's gradient."""
    kw = dict(vocab_size=256, dim=64, n_layers=1, n_heads=8, n_kv_heads=4, ffn_dim=128,
              max_seq_len=64)
    jcfg = jtfm.TransformerConfig(**kw, dtype=jnp.float32)
    layer = np_tree(jtfm.init_params(jcfg, jax.random.PRNGKey(0))["layers"][0])
    h, dh = normal((2, 16, 64), 1), normal((2, 16, 64), 2)
    cos, sin = jtfm.rope_frequencies(jcfg, jnp.arange(16))
    fn = lambda h, lyr: jtfm.layer_apply(h, lyr, jcfg, cos, sin)[0]
    out, vjp = jax.vjp(fn, jnp.asarray(h), layer)
    d_h, d_layer = vjp(jnp.asarray(dh))
    for r in world.run(w.tp_layer_case, kw, layer, h, dh):
        np.testing.assert_allclose(r["out"], np.asarray(out), **OUT)
        np.testing.assert_allclose(r["dh"], np.asarray(d_h), **GRAD)
        for name, g in d_layer.items():
            np.testing.assert_allclose(r["grads"][name], np.asarray(g), **GRAD, err_msg=name)


def test_shard_config_keeps_the_head_size_and_checks_divisibility():
    local = ttfm.shard_config(dataclasses.replace(ttfm.TINY, n_kv_heads=4), 4)
    assert (local.n_heads, local.n_kv_heads, local.ffn_dim, local.head_dim) == (1, 1, 32, 16)
    with pytest.raises(ValueError, match="n_kv_heads=2 not divisible"):
        ttfm.shard_config(ttfm.TINY, 4)


def test_param_partition_spec_tree_equals_the_references():
    for axis in ("model", None):
        ref = jtfm.param_partition_spec(jtfm.TINY, model_axis=axis)
        got = ttfm.param_partition_spec(ttfm.TINY, model_axis=axis)
        ref_flat = jax.tree_util.tree_flatten_with_path(ref, is_leaf=lambda s: isinstance(s, JP))[0]
        got_flat = jax.tree_util.tree_flatten_with_path(got, is_leaf=lambda s: isinstance(s, P))[0]
        assert [(jax.tree_util.keystr(p), tuple(s)) for p, s in ref_flat] == \
            [(jax.tree_util.keystr(p), tuple(s)) for p, s in got_flat]


def test_vocab_parallel_cross_entropy_matches_the_reference_and_its_grad(world):
    b, v = 16, 64
    logits = normal((b, v), 0, 3.0)
    labels = np.random.default_rng(1).integers(0, v, size=b)
    g = normal((b,), 2)
    loss, vjp = jax.vjp(lambda l: jxent_ref(l, jnp.asarray(labels)), jnp.asarray(logits))
    (grad,) = vjp(jnp.asarray(g))
    # the reference's vocab-parallel loss on its own 2 x 4 mesh too
    jmesh = jcreate_mesh({"data": 2, "model": 4}, devices=jax.devices()[:8])
    ref_vp = jax.jit(jvp(jmesh, axis="model", batch_axis="data"))(logits, labels)
    for r in world.run(w.vocab_parallel_case, {"data": 2, "model": 2}, logits, labels, g):
        np.testing.assert_allclose(r["loss"], np.asarray(loss), **OUT)
        np.testing.assert_allclose(r["loss"], np.asarray(ref_vp), **OUT)
        np.testing.assert_allclose(r["grad"], np.asarray(grad), **GRAD)


def test_vocab_parallel_axis_needs_a_mesh():
    with pytest.raises(ValueError, match="needs a mesh"):
        ttrainer.make_lm_train_step(ttfm.forward, ttfm.TINY, None, vocab_parallel_axis="model")


def jax_lm_steps(axes, params, tokens, steps, lr, vp_axis, attention=None):
    """The JAX package's mesh step ``steps`` times -> (losses, params
    after, the last step's gradients: its loss, as the step takes it,
    differentiated at the params that step starts from)."""
    jcfg = jtfm.TransformerConfig(**TINY32, dtype=jnp.float32)
    n = int(np.prod(list(axes.values())))
    mesh = jcreate_mesh(axes, devices=jax.devices()[:n])
    spec = jtfm.param_partition_spec(jcfg, model_axis="model" if "model" in axes else None)
    opt = optax.sgd(lr)
    fresh = jax.tree.map(jnp.asarray, params)
    state = {"params": jax.tree_util.tree_map(
        lambda p, s: jax.device_put(p, NamedSharding(mesh, s)), fresh, spec,
        is_leaf=lambda x: isinstance(x, JP)),
        "opt_state": opt.init(fresh), "step": jnp.zeros((), jnp.int32)}
    attn = attention(mesh) if attention else None
    step = jtrainer.make_lm_train_step(
        jtfm.forward, jcfg, opt, mesh=mesh, data_axis="data", param_spec=spec,
        attention_fn=attn, vocab_parallel_axis=vp_axis)
    vp = jvp(mesh, axis=vp_axis, batch_axis="data") if vp_axis else None

    def loss_fn(p, tok):  # the reference trainer's loss (training/trainer.py:208)
        logits = jtfm.forward(p, tok[:, :-1], jcfg, attention_fn=attn)
        b, t, v = logits.shape
        flat, labels = logits.reshape(b * t, v), tok[:, 1:].reshape(-1)
        return jnp.mean(vp(flat, labels) if vp else jxent(flat, labels))

    losses = []
    for i in range(steps):
        if i == steps - 1:
            grads = np_tree(jax.jit(jax.grad(loss_fn))(state["params"], jnp.asarray(tokens)))
        state, loss = step(state, jnp.asarray(tokens))
        losses.append(float(loss))
    return losses, np_tree(state["params"]), grads


@pytest.mark.parametrize("vocab_parallel", [False, True])
def test_lm_step_data2_model2_matches_the_reference(world, vocab_parallel):
    """Two SGD(1e-2) steps of the TINY LM on ``{"data": 2, "model": 2}``
    (heads, FFN and the LM head sharded), with and without the
    vocab-parallel loss, against the JAX package's mesh step."""
    jcfg = jtfm.TransformerConfig(**TINY32, dtype=jnp.float32)
    params = np_tree(jtfm.init_params(jcfg, jax.random.PRNGKey(0)))
    tokens = np.random.default_rng(1).integers(0, 256, size=(4, 33))
    axes = {"data": 2, "model": 2}
    vp = "model" if vocab_parallel else None
    ref_losses, ref_params, ref_grads = jax_lm_steps(axes, params, tokens, 2, 1e-2, vp)
    got = world.run(w.lm_mesh_step, axes, params, TINY32, tokens, 2, 1e-2, vocab_parallel)
    for r in got:
        np.testing.assert_allclose(r["losses"], ref_losses, rtol=LOSS_RTOL)
        assert_grads_close(ref_grads, r["grads"])
        assert_updates_close(params, ref_params, r["params"])


def test_opt_state_partition_spec_mirrors_params():
    """Adam's moments inherit their param's spec, step counts replicate;
    a prefix spec covers its whole subtree (SGD momentum)."""
    params = {"layers": [{"wq": torch.zeros(4, 4, requires_grad=True),
                          "b": torch.zeros(4, requires_grad=True)}],
              "embed": torch.zeros(8, 4, requires_grad=True)}
    spec = {"layers": [{"wq": P(None, "model"), "b": P()}], "embed": P()}
    opt = ttrainer.adamw(1e-3)(ttrainer.param_leaves(params))
    assert ttrainer.opt_state_partition_spec(opt, spec, params) == [{}, {}, {}]
    sum(p.sum() for p in ttrainer.param_leaves(params)).backward()
    opt.step()
    got = ttrainer.opt_state_partition_spec(opt, spec, params)
    # param_leaves order: embed, layers[0].b, layers[0].wq
    assert got[2] == {"step": P(), "exp_avg": P(None, "model"), "exp_avg_sq": P(None, "model")}
    assert got[0]["exp_avg"] == P() and got[1]["exp_avg_sq"] == P()
    # the reference's tree gives the same specs to its mu/nu leaves
    jparams = {"layers": [{"wq": jnp.zeros((4, 4)), "b": jnp.zeros((4,))}],
               "embed": jnp.zeros((8, 4))}
    jspec = {"layers": [{"wq": JP(None, "model"), "b": JP()}], "embed": JP()}
    osd = jtrainer.opt_state_partition_spec(optax.adamw(1e-3).init(jparams), jspec)
    flat = jax.tree_util.tree_flatten_with_path(osd, is_leaf=lambda s: isinstance(s, JP))[0]
    assert {tuple(s) for p, s in flat if "wq" in jax.tree_util.keystr(p)} == {(None, "model")}

    params2 = {"stages": {"wq": torch.zeros(2, 4, 4, requires_grad=True)},
               "embed": torch.zeros(8, requires_grad=True)}
    spec2 = {"stages": P("pipe"), "embed": P()}
    opt2 = ttrainer.sgd(0.1, momentum=0.9)(ttrainer.param_leaves(params2))
    sum(p.sum() for p in ttrainer.param_leaves(params2)).backward()
    opt2.step()
    got2 = ttrainer.opt_state_partition_spec(opt2, spec2, params2)
    assert got2 == [{"momentum_buffer": P()}, {"momentum_buffer": P("pipe")}]


def test_default_attention_with_unequal_lengths_is_full_attention():
    """T_q != T_k goes to ``full_attention``, as the reference's branch."""
    q, k, v = normal((2, 8, 4, 16), 0), normal((2, 24, 4, 16), 1), normal((2, 24, 4, 16), 2)
    for causal in (True, False):
        ref = jtfm.default_attention(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), causal=causal)
        got = ttfm.default_attention(torch.from_numpy(q), torch.from_numpy(k),
                                     torch.from_numpy(v), causal=causal)
        np.testing.assert_allclose(got.numpy(), np.asarray(ref), **OUT)
