"""Ring attention and Ulysses over a gloo world of 4 ranks against the
JAX package's ``full_attention`` and its ``jax.grad``.

Each rank holds its block of float32 q/k/v (sequence over ``seq``;
batch and heads co-sharded over ``data`` and ``model`` in the mixed
cases); the outputs and input gradients are gathered and compared with
the reference on the whole tensors. Tolerances: ``rtol=1e-5,
atol=1e-6`` for outputs and gradients (float32, the same arithmetic in
another order: blocks, sub-blocks, an online softmax).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from devspace_tpu.parallel.ring_attention import full_attention as jfull
from devspace_tpu.parallel.ring_attention import ring_attention as jring
from devspace_tpu.parallel.mesh import create_mesh as jcreate_mesh
import torch_parallel_workers as w
from torch_parallel_world import World

TOL = dict(rtol=1e-5, atol=1e-6)


@pytest.fixture(scope="module")
def world(tmp_path_factory):
    wd = World(4, tmp_path_factory.mktemp("gloo"))
    yield wd
    wd.close()


def qkvd(shape, seed):
    rng = np.random.default_rng(seed)
    return [rng.standard_normal(shape).astype(np.float32) for _ in range(4)]


def reference(q, k, v, dout, causal):
    out, vjp = jax.vjp(lambda a, b, c: jfull(a, b, c, causal=causal), q, k, v)
    dq, dk, dv = vjp(jnp.asarray(dout))
    return {"out": out, "dq": dq, "dk": dk, "dv": dv}


def check(got, ref):
    for name in ("out", "dq", "dk", "dv"):
        np.testing.assert_allclose(got[name], np.asarray(ref[name]), **TOL, err_msg=name)


CASES = {
    # name: (axes, spec of q/k/v [B, T, H, D], shape, block_size)
    "ring4": ({"seq": 4}, (None, "seq"), (2, 64, 4, 8), 512),
    "ring4_subblocked": ({"seq": 4}, (None, "seq"), (2, 32, 4, 8), 4),
    "data2_seq2": ({"data": 2, "seq": 2}, ("data", "seq"), (4, 32, 4, 8), 8),
    "seq2_heads2": ({"seq": 2, "model": 2}, (None, "seq", "model"), (2, 48, 4, 8), 8),
}


@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("case", sorted(CASES))
def test_ring_attention_matches_full_attention_and_its_grad(world, case, causal):
    axes, spec, shape, block = CASES[case]
    q, k, v, dout = qkvd(shape, seed=len(case))
    got = world.run(w.attention_case, "ring", axes, spec, q, k, v, dout, causal, block)
    for r in got:
        check(r, reference(q, k, v, dout, causal))
        assert r["warnings"] == []


def test_ring_attention_equals_the_reference_ring_on_its_mesh(world):
    """Against the JAX package's own ring (sub-blocked) on a 4-device
    mesh, output to output."""
    q, k, v, dout = qkvd((2, 32, 4, 8), seed=7)
    mesh = jcreate_mesh({"seq": 4}, devices=jax.devices()[:4])
    ref = jring(mesh, axis="seq", causal=True, block_size=4)(q, k, v)
    got = world.run(w.attention_case, "ring", {"seq": 4}, (None, "seq"), q, k, v, dout, True, 4)
    np.testing.assert_allclose(got[0]["out"], np.asarray(ref), **TOL)


def test_ring_block_size_degrades_to_a_divisor_without_warning(world):
    # t_local = 96 (the reference's case): block_size 40 does not divide
    # it and falls to the divisor 32 (>= max(16, 40 // 4)), silently
    q, k, v, dout = qkvd((1, 384, 2, 8), seed=3)
    got = world.run(w.attention_case, "ring", {"seq": 4}, (None, "seq"), q, k, v, dout, True, 40)
    check(got[0], reference(q, k, v, dout, True))
    assert got[0]["warnings"] == []


def test_ring_block_size_without_a_usable_divisor_warns_and_runs_whole_blocks(world):
    q, k, v, dout = qkvd((1, 28, 2, 8), seed=4)  # t_local = 7, prime
    got = world.run(w.attention_case, "ring", {"seq": 4}, (None, "seq"), q, k, v, dout, True, 3)
    check(got[0], reference(q, k, v, dout, True))
    # 3 < 7 does not divide it and no divisor is >= 16: whole blocks
    assert any("no usable divisor" in m for m in got[0]["warnings"])


@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("case", ["seq4", "data2_seq2"])
def test_ulysses_matches_full_attention_and_its_grad(world, case, causal):
    axes, spec = {"seq4": ({"seq": 4}, (None, "seq")),
                  "data2_seq2": ({"data": 2, "seq": 2}, ("data", "seq"))}[case]
    q, k, v, dout = qkvd((2, 64, 8, 8), seed=11)
    got = world.run(w.attention_case, "ulysses", axes, spec, q, k, v, dout, causal)
    for r in got:
        check(r, reference(q, k, v, dout, causal))


def test_ulysses_rejects_indivisible_heads(world):
    q = np.zeros((1, 16, 6, 8), np.float32)  # 6 heads on a 4-way axis
    for msg in world.run(w.ulysses_indivisible, q):
        assert "divisible" in msg and "(6)" in msg
