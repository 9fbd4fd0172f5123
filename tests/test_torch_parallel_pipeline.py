"""The port's 1F1B pipeline (``parallel/pipeline.py``) over a gloo world of
4 ranks against the JAX package's on its 8-device CPU mesh.

TINY in float32 with 4 layers, inputs from numpy seeds, params carried
across by ``models/convert.py``. Tolerances (as in
``test_torch_parallel_tp``): the loss within ``1e-5`` relative; each
leaf's gradient within ``1e-4`` of the reference's largest value of that
leaf; a step's update within ``1e-4`` of the reference's largest change
of the leaf or one float32 ulp of the leaf. Layouts and specs are
compared exactly; ``pipeline_apply`` against the stages run one after
another, ``rtol=1e-5, atol=1e-6``.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest

from devspace_tpu.models import transformer as jtfm
from devspace_tpu.parallel import pipeline as jpipe
from devspace_tpu.parallel.mesh import create_mesh as jcreate_mesh
from devspace_tpu_torch.models import transformer as ttfm
from devspace_tpu_torch.models.convert import params_from_numpy, params_to_numpy
from devspace_tpu_torch.parallel import pipeline as tpipe
from devspace_tpu_torch.parallel.mesh import P
import torch_parallel_workers as w
from test_torch_parallel_tp import (
    TINY32,
    assert_grads_close,
    assert_updates_close,
    normal,
    np_tree,
)
from torch_parallel_world import World

LOSS_RTOL = 1e-5
RUN_TIMEOUT = 180.0  # a deadlocked hop fails the test instead of hanging the suite
TINY4 = {**TINY32, "n_layers": 4}
S, M, MB, T = 4, 4, 2, 16


@pytest.fixture(scope="module")
def world(tmp_path_factory):
    wd = World(4, tmp_path_factory.mktemp("gloo"))
    yield wd
    wd.close()


@pytest.fixture(scope="module")
def case():
    cfg = jtfm.TransformerConfig(**TINY4, dtype=jnp.float32)
    params = np_tree(jtfm.init_params(cfg, jax.random.PRNGKey(0)))
    tokens = np.asarray(jax.random.randint(jax.random.PRNGKey(1), (M, MB, T + 1), 0, 256))
    return cfg, params, tokens


def spec_tuples(tree):
    return jax.tree.map(tuple, tree, is_leaf=lambda x: isinstance(x, (tuple, P)))


@pytest.mark.parametrize("tp_axis", [None, "model"])
def test_param_specs_equal_the_reference(tp_axis):
    assert spec_tuples(tpipe.pipeline_param_specs("pipe", tp_axis)) == \
        spec_tuples(jpipe.pipeline_param_specs("pipe", tp_axis))
    assert spec_tuples(tpipe.interleaved_param_specs("pipe", tp_axis)) == \
        spec_tuples(jpipe.interleaved_param_specs("pipe", tp_axis))


@pytest.mark.parametrize("layout", ["1f1b", "interleaved"])
def test_stage_layouts_equal_the_reference_and_round_trip(case, layout):
    _, params, _ = case
    tparams = params_from_numpy(params, "cpu")
    if layout == "1f1b":
        ref = jpipe.transformer_stage_params(params, 2)
        got = tpipe.transformer_stage_params(tparams, 2)
        back = tpipe.transformer_unstage_params(got)
    else:
        ref = jpipe.transformer_interleaved_stage_params(params, 2, 2)
        got = tpipe.transformer_interleaved_stage_params(tparams, 2, 2)
        back = tpipe.transformer_uninterleave_params(got)
    jax.tree.map(np.testing.assert_array_equal, np_tree(ref), params_to_numpy(got))
    jax.tree.map(np.testing.assert_array_equal, params, params_to_numpy(back))


def test_layouts_refuse_layers_that_do_not_divide(case):
    tparams = params_from_numpy(case[1], "cpu")
    with pytest.raises(ValueError, match="not divisible by 3 stages"):
        tpipe.transformer_stage_params(tparams, 3)
    with pytest.raises(ValueError, match="not divisible by 2 stages x 3 chunks"):
        tpipe.transformer_interleaved_stage_params(tparams, 2, 3)


@pytest.mark.parametrize("n_stages,n_micro", [(1, 3), (2, 4), (4, 4), (4, 7), (3, 2)])
def test_one_f_one_b_hops_are_consumed_the_tick_after(n_stages, n_micro):
    """Each hop of the plan is what its receiver works on next tick, and
    every microbatch crosses each stage boundary once in each
    direction: the send and receive sides pair up one to one."""
    plan = tpipe.one_f_one_b_hops(n_stages, n_micro)
    seen = {tpipe.FWD: [], tpipe.BWD: []}
    for tau, hops in enumerate(plan):
        for h in hops:
            nxt = (tpipe._f_mb if h.kind == tpipe.FWD else tpipe._b_mb)(
                h.dst, tau + 1, n_stages, n_micro)
            assert nxt == h.mb, (tau, h)
            seen[h.kind].append((h.src, h.mb))
        assert len({(h.dst, h.kind) for h in hops}) == len(hops)  # one buffer each
    want_f = sorted((s, m) for s in range(n_stages - 1) for m in range(n_micro))
    want_b = sorted((s, m) for s in range(1, n_stages) for m in range(n_micro))
    assert sorted(seen[tpipe.FWD]) == want_f and sorted(seen[tpipe.BWD]) == want_b


@pytest.mark.parametrize("axes", [{"pipe": 4}, {"pipe": 2, "model": 2}])
def test_pipeline_apply_equals_the_stages_in_sequence(world, axes):
    d = 8
    ws = normal((axes["pipe"], d, d), 0, d ** -0.5)
    xs = normal((3, 2, d), 1)
    ref = xs
    for s in range(axes["pipe"]):
        ref = np.tanh(ref @ ws[s])
    for got in world.run(w.pipeline_apply_case, axes, ws, xs, timeout=RUN_TIMEOUT):
        np.testing.assert_allclose(got, ref, rtol=1e-5, atol=1e-6)


def test_one_f_one_b_loss_and_grads_match_the_reference(world, case):
    cfg, params, tokens = case
    mesh = jcreate_mesh({"pipe": S}, devices=jax.devices()[:S])
    staged = jpipe.transformer_stage_params(params, S)
    ref_loss, ref_grads = jax.jit(jpipe.pipeline_lm_loss_and_grads(mesh, cfg, M))(staged, tokens)
    for r in world.run(w.pipeline_loss_grads, {"pipe": S}, params, TINY4, tokens,
                       timeout=RUN_TIMEOUT):
        assert abs(r["loss"] - float(ref_loss)) <= LOSS_RTOL * abs(float(ref_loss))
        assert_grads_close(np_tree(ref_grads), r["grads"])


def test_one_f_one_b_train_step_matches_the_reference(world, case):
    """Two SGD(momentum 0.9) steps of ``make_pipeline_lm_train_step``:
    losses and updates as the JAX step's; the moments live where their
    stage params do."""
    cfg, params, tokens = case
    mesh = jcreate_mesh({"pipe": S}, devices=jax.devices()[:S])
    staged = jpipe.transformer_stage_params(params, S)
    opt = optax.sgd(1e-2, momentum=0.9)
    state = {"params": staged, "opt_state": opt.init(staged), "step": jnp.zeros((), jnp.int32)}
    step = jpipe.make_pipeline_lm_train_step(mesh, cfg, opt, M, donate=False)
    losses = []
    for _ in range(2):
        state, loss = step(state, tokens)
        losses.append(float(loss))
    for r in world.run(w.pipeline_train_steps, {"pipe": S}, params, TINY4, tokens, 2, 1e-2,
                       timeout=RUN_TIMEOUT):
        np.testing.assert_allclose(r["losses"], losses, rtol=LOSS_RTOL)
        assert losses[1] < losses[0] and r["step"] == 2
        assert_updates_close(np_tree(staged), np_tree(state["params"]), r["params"])
        stage_specs = {tuple(s["momentum_buffer"]) for s in r["opt_spec"]
                       if "momentum_buffer" in s}
        assert stage_specs == {("pipe",), ()}


def test_one_f_one_b_refuses_a_model_axis_that_does_not_divide_the_heads(case):
    cfg = dataclasses.replace(ttfm.TINY, n_kv_heads=3, n_heads=3)

    class OneAxis:
        def size(self, axis):
            return {"pipe": 1, "model": 2}[axis]

        def group(self, axis):
            raise AssertionError("the check comes before any group is used")

    with pytest.raises(ValueError, match=r"n_heads=3 not divisible by the model axis \(2\)"):
        tpipe.pipeline_lm_loss_and_grads(OneAxis(), cfg, 2, tp_axis="model")
