"""The port's interleaved (virtual-stage) 1F1B against the JAX package's:
the schedule builder's tables field for field over an (S, V, M) grid,
Megatron's bubble bound, the hops read off the tables, and the executor
and its train step at S = 2, V = 2 over a gloo world of 2 ranks.

TINY in float32 with 4 layers (4 virtual stages of one layer), inputs
from numpy seeds. Tolerances: the tables exactly; the loss within
``1e-5`` relative; each leaf's gradient within ``1e-4`` of the
reference's largest value of that leaf; a step's update within ``1e-4``
of the reference's largest change of the leaf or one float32 ulp of the
leaf (``test_torch_parallel_tp``).
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest

from devspace_tpu.models import transformer as jtfm
from devspace_tpu.parallel import interleaved as jil
from devspace_tpu.parallel import pipeline as jpipe
from devspace_tpu.parallel.mesh import create_mesh as jcreate_mesh
from devspace_tpu_torch.parallel import interleaved as til
from devspace_tpu_torch.parallel import pipeline as tpipe
import torch_parallel_workers as w
from test_torch_parallel_tp import TINY32, assert_grads_close, assert_updates_close, np_tree
from torch_parallel_world import World

LOSS_RTOL = 1e-5
RUN_TIMEOUT = 180.0  # a deadlocked hop fails the test instead of hanging the suite
TINY4 = {**TINY32, "n_layers": 4}
S, V, M, MB, T = 2, 2, 4, 2, 16
GRID = [(1, 2, 4), (2, 2, 4), (2, 2, 8), (4, 2, 8), (2, 4, 8), (4, 4, 8), (2, 2, 2),
        (3, 2, 6), (8, 2, 16), (2, 1, 4), (2, 3, 6), (8, 2, 10), (4, 3, 5), (2, 2, 3)]


@pytest.fixture(scope="module")
def world(tmp_path_factory):
    wd = World(S, tmp_path_factory.mktemp("gloo"))
    yield wd
    wd.close()


@pytest.fixture(scope="module")
def case():
    cfg = jtfm.TransformerConfig(**TINY4, dtype=jnp.float32)
    params = np_tree(jtfm.init_params(cfg, jax.random.PRNGKey(2)))
    tokens = np.asarray(jax.random.randint(jax.random.PRNGKey(3), (M, MB, T + 1), 0, 256))
    return cfg, params, tokens


@pytest.mark.parametrize("s,v,m", GRID)
def test_schedule_equals_the_reference_field_for_field(s, v, m):
    ref, got = jil.build_interleaved_schedule(s, v, m), til.build_interleaved_schedule(s, v, m)
    for field in dataclasses.fields(ref):
        a, b = getattr(ref, field.name), getattr(got, field.name)
        if isinstance(a, np.ndarray):
            np.testing.assert_array_equal(b, a, err_msg=field.name)
            assert b.dtype == a.dtype
        else:
            assert a == b, field.name
    assert got.bubble_fraction == ref.bubble_fraction
    assert (til.OP_IDLE, til.OP_F, til.OP_B) == (jil.OP_IDLE, jil.OP_F, jil.OP_B)


@pytest.mark.parametrize("s,v,m", [g for g in GRID if g[2] % g[0] == 0])
def test_schedule_hits_the_megatron_bubble_bound(s, v, m):
    """With S | M: exactly 2*(S-1) idle chunk-ticks a rank, a bubble
    fraction of (S-1)/(M*V + S-1) (``tests/test_parallel.py``'s bound)."""
    sched = til.build_interleaved_schedule(s, v, m)
    assert sched.total_ticks - 2 * m * v == 2 * (s - 1)
    assert abs(sched.bubble_fraction - (s - 1) / (m * v + s - 1)) < 1e-9


@pytest.mark.parametrize("s,v,m", GRID)
def test_hops_match_the_routing_tables(s, v, m):
    """The hops each rank sends (from the op tables) are the hops each
    rank files (from the routing tables), and every virtual-stage
    boundary is crossed once per microbatch in each direction."""
    sched = til.build_interleaved_schedule(s, v, m)
    plan = tpipe.interleaved_hops(sched)
    n = sum(len(h) for h in plan)
    assert n == 2 * (s * v - 1) * m
    for hops in plan:
        assert len({(h.dst, h.kind) for h in hops}) == len(hops)


def test_hops_refuse_a_routing_table_that_disagrees():
    sched = til.build_interleaved_schedule(2, 2, 4)
    bad = sched.recv_f_slot.copy()
    tau, s = np.argwhere(sched.recv_f_chunk >= 0)[0]
    bad[tau, s] += 1
    with pytest.raises(RuntimeError, match="hops sent"):
        tpipe.interleaved_hops(dataclasses.replace(sched, recv_f_slot=bad))


def test_interleaved_loss_and_grads_match_the_reference(world, case):
    cfg, params, tokens = case
    mesh = jcreate_mesh({"pipe": S}, devices=jax.devices()[:S])
    staged = jpipe.transformer_interleaved_stage_params(params, S, V)
    ref_loss, ref_grads = jax.jit(
        jpipe.interleaved_pipeline_lm_loss_and_grads(mesh, cfg, M, V))(staged, tokens)
    for r in world.run(w.pipeline_loss_grads, {"pipe": S}, params, TINY4, tokens, V,
                       timeout=RUN_TIMEOUT):
        assert abs(r["loss"] - float(ref_loss)) <= LOSS_RTOL * abs(float(ref_loss))
        assert_grads_close(np_tree(ref_grads), r["grads"])


def test_interleaved_train_step_matches_the_reference(world, case):
    cfg, params, tokens = case
    mesh = jcreate_mesh({"pipe": S}, devices=jax.devices()[:S])
    staged = jpipe.transformer_interleaved_stage_params(params, S, V)
    opt = optax.sgd(1e-2, momentum=0.9)
    state = {"params": staged, "opt_state": opt.init(staged), "step": jnp.zeros((), jnp.int32)}
    step = jpipe.make_interleaved_pipeline_lm_train_step(mesh, cfg, opt, M, V, donate=False)
    losses = []
    for _ in range(2):
        state, loss = step(state, tokens)
        losses.append(float(loss))
    for r in world.run(w.pipeline_train_steps, {"pipe": S}, params, TINY4, tokens, 2, 1e-2, V,
                       timeout=RUN_TIMEOUT):
        np.testing.assert_allclose(r["losses"], losses, rtol=LOSS_RTOL)
        assert_updates_close(np_tree(staged), np_tree(state["params"]), r["params"])
        assert {tuple(s["momentum_buffer"]) for s in r["opt_spec"]} == {(None, "pipe"), ()}
