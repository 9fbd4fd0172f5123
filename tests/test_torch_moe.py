"""The port's MoE (routing, the dense expert layer, the model and its train
step) against the JAX package's, on the CPU.

A float32 copy of ``TINY_MOE``; the reference's params carried across by
``models/convert.params_from_numpy``, router probabilities and tokens
from numpy seeds. The JAX side runs as its own tests run it on the CPU
(its attention and loss kernels in interpret mode).

Tolerances:
- routing: dispatch equal; combine and aux within ``1e-6`` (float32,
  the same operations);
- ``moe_ffn_reference``, ``forward``'s logits and aux: ``rtol=1e-4,
  atol=1e-5``;
- ``moe_ffn_reference`` in bfloat16: the mean error within ``1e-3`` of
  the mean magnitude and the largest within ``2**-8`` of the largest
  output (one bfloat16 rounding: the port and the reference round the
  same float32 values, and differ only where a sum in another order
  falls on the other side of a rounding; rounding the up-projection
  before the activation as well moves most outputs, by ~3e-3 on average);
- three AdamW(1e-3) steps: loss, ce and aux ``rtol=1e-5``; every param
  within ``1e-4`` (a tenth of one step: Adam divides each gradient by its
  own running RMS, so an element whose gradient sits at float32 noise may
  take another fraction of its step).
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from devspace_tpu.models import moe as jmoe
from devspace_tpu.parallel import expert_parallel as jep
from devspace_tpu.training import trainer as jtrainer
from devspace_tpu_torch.models import moe as tmoe
from devspace_tpu_torch.models.convert import params_from_numpy, params_to_numpy
from devspace_tpu_torch.parallel import expert_parallel as tep
from devspace_tpu_torch.training import trainer as ttrainer

ROUTE_ATOL = 1e-6
FWD = dict(rtol=1e-4, atol=1e-5)
LOSS_RTOL = 1e-5
PARAM_ATOL = 1e-4
BF16_MEAN_REL, BF16_MAX_REL = 1e-3, 2.0 ** -8
LR = 1e-3


@pytest.fixture(autouse=True)
def few_torch_threads():
    """At most two torch threads: the suite's workers share the cores, and
    torch's many small ops on all of them spin against each other (ten
    times slower under load)."""
    n = torch.get_num_threads()
    torch.set_num_threads(min(n, 2))
    yield
    torch.set_num_threads(n)


@pytest.fixture
def pallas_interpret(monkeypatch):
    monkeypatch.setenv("DEVSPACE_PALLAS_INTERPRET", "1")


@pytest.fixture(scope="module")
def tiny():
    jcfg = dataclasses.replace(jmoe.TINY_MOE, dtype=jnp.float32)
    tcfg = dataclasses.replace(tmoe.TINY_MOE, dtype=torch.float32)
    jparams = jax.jit(jmoe.init_params, static_argnums=0)(jcfg, jax.random.PRNGKey(0))
    return jcfg, tcfg, jax.tree.map(np.asarray, jparams)


def probs(t, e, seed):
    logits = np.random.default_rng(seed).normal(size=(t, e)).astype(np.float32) * 2
    return np.asarray(jax.nn.softmax(jnp.asarray(logits), axis=-1))


def test_configs_match_the_reference():
    for name in ("MIXTRAL_8X7B", "TINY_MOE"):
        j, t = getattr(jmoe, name), getattr(tmoe, name)
        for field in dataclasses.fields(t):
            if field.name != "dtype":
                assert getattr(t, field.name) == getattr(j, field.name), (name, field.name)
        assert t.head_dim == j.head_dim and t.dtype == torch.bfloat16
    for args in ((16, 4, 2.0, 2), (16, 4, 0.5, 2), (4096, 8, 2.0, 2), (3, 8, 1.25, 1)):
        assert tep.expert_capacity(*args) == jep.expert_capacity(*args)


@pytest.mark.parametrize("k", [1, 2])
@pytest.mark.parametrize("capacity_factor", [2.0, 1.0, 0.5])
def test_route_matches_the_reference(capacity_factor, k):
    """Dispatch equal; combine and aux within 1e-6. At capacity factor
    0.5 every expert overflows, so tokens are dropped in the
    reference's order (earlier tokens and earlier choices first)."""
    t, e = 24, 4
    p = probs(t, e, seed=int(capacity_factor * 10) + k)
    cap = jep.expert_capacity(t, e, capacity_factor, k)
    jd, jc, ja = jep._route(jnp.asarray(p), k, cap)
    td, tc, ta = tep._route(torch.from_numpy(np.array(p)), k, cap)
    assert td.dtype == torch.bool and td.shape == (t, e, cap)
    np.testing.assert_array_equal(td.numpy(), np.asarray(jd))
    np.testing.assert_allclose(tc.numpy(), np.asarray(jc), rtol=0, atol=ROUTE_ATOL)
    np.testing.assert_allclose(ta.item(), float(ja), rtol=0, atol=ROUTE_ATOL)
    kept = td.numpy().any(axis=(1, 2)).sum()
    if capacity_factor == 0.5:
        assert kept < t  # some tokens were dropped
    assert (td.numpy().sum(axis=0) <= 1).all()  # one token a slot


@pytest.mark.parametrize("fused", [True, False], ids=["swiglu", "gelu"])
def test_moe_ffn_reference_matches(fused, tiny):
    """The dense expert layer: TINY_MOE's first layer with SwiGLU experts,
    and ``init_moe_params``'s plain experts with the default GELU."""
    jcfg, _, jparams = tiny
    rng = np.random.default_rng(3)
    if fused:
        params, kw = jparams["layers"][0]["moe"], dict(activation=(jep.swiglu, tep.swiglu))
    else:
        params = jax.tree.map(np.asarray, jep.init_moe_params(
            jax.random.PRNGKey(1), 16, 24, 4, dtype=jnp.float32))
        kw = dict(activation=(jax.nn.gelu, tep.gelu))
    d = params["w_up"].shape[1]
    x = rng.normal(size=(20, d)).astype(np.float32)
    jy, ja = jep.moe_ffn_reference(jnp.asarray(x), params, k=2, capacity_factor=1.0,
                                   activation=kw["activation"][0])
    tparams = {name: torch.from_numpy(np.array(a)) for name, a in params.items()}
    ty, ta = tep.moe_ffn_reference(torch.from_numpy(x), tparams, k=2, capacity_factor=1.0,
                                   activation=kw["activation"][1])
    np.testing.assert_allclose(ty.numpy(), np.asarray(jy), **FWD)
    np.testing.assert_allclose(ta.item(), float(ja), **FWD)


@pytest.mark.parametrize("fused", [True, False], ids=["swiglu", "gelu"])
def test_moe_ffn_reference_bf16_rounds_as_the_reference(fused):
    """bfloat16 experts: the up-projection's float32 result goes through
    the activation before it is rounded, as the reference's
    ``preferred_element_type=float32`` has it."""
    rng = np.random.default_rng(6)
    d, f, e = 64, 96, 4
    up = 2 * f if fused else f
    params = {"w_gate": (rng.normal(size=(d, e)) * 0.2).astype(np.float32),
              "w_up": jnp.asarray(rng.normal(size=(e, d, up)) * 0.2, jnp.bfloat16),
              "w_down": jnp.asarray(rng.normal(size=(e, f, d)) * 0.2, jnp.bfloat16)}
    x = jnp.asarray(rng.normal(size=(64, d)), jnp.bfloat16)
    jact, tact = (jep.swiglu, tep.swiglu) if fused else (jax.nn.gelu, tep.gelu)
    jy, ja = jep.moe_ffn_reference(x, params, k=2, capacity_factor=1.0, activation=jact)

    def to_torch(a):
        t = torch.from_numpy(np.asarray(jnp.asarray(a, jnp.float32)).copy())
        return t.to(torch.bfloat16) if a.dtype == jnp.bfloat16 else t

    tparams = {name: to_torch(a) for name, a in params.items()}
    ty, ta = tep.moe_ffn_reference(to_torch(x), tparams, k=2, capacity_factor=1.0,
                                   activation=tact)
    assert ty.dtype == torch.bfloat16
    ty, jy = ty.float().numpy(), np.asarray(jy, np.float32)
    err = np.abs(ty - jy)
    assert err.mean() <= BF16_MEAN_REL * np.abs(jy).mean(), err.mean() / np.abs(jy).mean()
    assert err.max() <= BF16_MAX_REL * np.abs(jy).max(), err.max() / np.abs(jy).max()
    np.testing.assert_allclose(ta.item(), float(ja), **FWD)


def test_bf16_up_product_gradients_follow_the_float32_ones():
    """The float32-result product's backward (the gradient rounded to
    bfloat16, then bfloat16 products with float32 sums) against float32
    autograd on the same bfloat16 inputs: within ``2**-7`` of each
    gradient's largest value (two bfloat16 roundings)."""
    rng = np.random.default_rng(8)
    a = torch.from_numpy(rng.normal(size=(3, 8, 16)).astype(np.float32)).bfloat16()
    b = torch.from_numpy(rng.normal(size=(3, 16, 12)).astype(np.float32)).bfloat16()
    g = torch.from_numpy(rng.normal(size=(3, 8, 12)).astype(np.float32))
    a16, b16 = a.clone().requires_grad_(), b.clone().requires_grad_()
    y = tep._up_product(a16, b16)
    assert y.dtype == torch.float32
    y.backward(g)
    a32, b32 = a.float().requires_grad_(), b.float().requires_grad_()
    y32 = torch.bmm(a32, b32)
    y32.backward(g)
    torch.testing.assert_close(y, y32, rtol=1e-6, atol=1e-6)
    for got, want in ((a16.grad, a32.grad), (b16.grad, b32.grad)):
        assert got.dtype == torch.bfloat16
        assert (got.float() - want).abs().max() <= 2.0 ** -7 * want.abs().max()


def test_forward_logits_and_aux_match(tiny, pallas_interpret):
    jcfg, tcfg, jparams = tiny
    tokens = np.random.default_rng(4).integers(0, jcfg.vocab_size, size=(2, 12))
    jl, ja = jmoe.forward(jparams, jnp.asarray(tokens), jcfg)
    params = params_from_numpy(jparams, "cpu")
    assert params["layers"][1]["moe"]["w_gate"].dtype == torch.float32
    tl, ta = tmoe.forward(params, torch.from_numpy(tokens), tcfg)
    assert tl.dtype == torch.float32 and tl.shape == (2, 12, jcfg.vocab_size)
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), **FWD)
    np.testing.assert_allclose(ta.item(), float(ja), **FWD)


def test_params_tree_round_trips_and_keeps_the_router_float32(tiny):
    _, _, jparams = tiny
    back = params_to_numpy(params_from_numpy(jparams, "cpu"))
    jax.tree.map(np.testing.assert_array_equal, back, jparams)
    cast = params_from_numpy(jparams, "cpu", dtype=torch.bfloat16)
    assert cast["layers"][0]["moe"]["w_gate"].dtype == torch.float32
    assert cast["layers"][0]["moe"]["w_up"].dtype == torch.bfloat16
    assert cast["layers"][0]["attn_norm"].dtype == torch.float32
    own = tmoe.init_params(tmoe.TINY_MOE, torch.Generator().manual_seed(0))
    mine = jax.tree.map(lambda a: (a.shape, a.dtype.name), params_to_numpy(own))
    assert mine == jax.tree.map(lambda a: (a.shape, a.dtype.name),
                                jax.tree.map(np.asarray, jmoe.init_params(
                                    jmoe.TINY_MOE, jax.random.PRNGKey(0))))
    leaves = ttrainer.param_leaves(own)
    assert len(leaves) == 3 + 2 * 9  # embed, final_norm, lm_head; 6 + 3 (moe) a layer
    rebuilt = ttrainer.tree_like(own, leaves)
    assert rebuilt["layers"][1]["moe"]["w_down"] is own["layers"][1]["moe"]["w_down"]
    assert list(rebuilt) == list(own) and list(rebuilt["layers"][0]) == list(own["layers"][0])
    # leaves in jax.tree.leaves' order (keys sorted at every level),
    # whatever order each dict was built in
    shapes = [tuple(t.shape) for t in leaves]
    assert shapes == [a.shape for a in jax.tree.leaves(params_to_numpy(own))]

    def reversed_keys(node):
        if isinstance(node, dict):
            return {k: reversed_keys(node[k]) for k in reversed(list(node))}
        if isinstance(node, list):
            return [reversed_keys(c) for c in node]
        return node

    assert all(a is b for a, b in zip(ttrainer.param_leaves(reversed_keys(own)), leaves))


def test_three_adamw_steps_match_optax(tiny, pallas_interpret):
    jcfg, tcfg, jparams = tiny
    opt = optax.adamw(LR)
    jstate = {"params": jax.tree.map(jnp.asarray, jparams), "opt_state": None,
              "step": jnp.zeros((), jnp.int32)}
    jstate["opt_state"] = opt.init(jstate["params"])
    jstep = jtrainer.make_moe_lm_train_step(jmoe.forward, jcfg, opt, donate=False)
    tparams = params_from_numpy(jparams, "cpu", trainable=True)
    tstate = ttrainer.init_train_state(tparams, ttrainer.adamw(LR))
    tstep = ttrainer.make_moe_lm_train_step(tmoe.forward, tcfg, ttrainer.adamw(LR))
    rng = np.random.default_rng(5)
    for _ in range(3):
        tokens = rng.integers(0, jcfg.vocab_size, size=(2, 17))
        jstate, jm = jstep(jstate, jnp.asarray(tokens))
        tstate, tm = tstep(tstate, torch.from_numpy(tokens))
        for key in ("loss", "ce", "aux"):
            np.testing.assert_allclose(tm[key].item(), float(jm[key]), rtol=LOSS_RTOL, err_msg=key)
        np.testing.assert_allclose(tm["loss"].item(),
                                   tm["ce"].item() + tcfg.aux_weight * tm["aux"].item(), rtol=1e-6)
    assert tstate["step"] == 3
    jax.tree.map(lambda g, w: np.testing.assert_allclose(g, np.asarray(w), rtol=0, atol=PARAM_ATOL),
                 params_to_numpy(tstate["params"]), jstate["params"])


def test_moe_train_step_learns():
    """The port of tests/test_models_ops.py::test_moe_train_step_learns on
    one device (the dense routing; the expert-parallel layer waits for
    parallel/): ce drops below 0.7 of the first step's over 30 Adam steps
    on one batch; aux stays finite."""
    cfg = tmoe.MoEConfig(vocab_size=64, dim=32, n_layers=2, n_heads=4, n_kv_heads=2, ffn_dim=64,
                         num_experts=8, experts_per_token=2, capacity_factor=4.0, max_seq_len=64,
                         dtype=torch.float32)
    params = tmoe.init_params(cfg, torch.Generator().manual_seed(0))
    for p in ttrainer.param_leaves(params):
        p.requires_grad_()
    state = ttrainer.init_train_state(params, ttrainer.adam(3e-3))
    step = ttrainer.make_moe_lm_train_step(tmoe.forward, cfg, ttrainer.adam(3e-3))
    tokens = torch.from_numpy(np.random.default_rng(1).integers(0, cfg.vocab_size, size=(8, 17)))
    ces = []
    for _ in range(30):
        state, metrics = step(state, tokens)
        ces.append(metrics["ce"].item())
        assert np.isfinite(metrics["aux"].item())
    assert all(np.isfinite(ces))
    assert ces[-1] < ces[0] * 0.7, f"no learning: {ces[0]} -> {ces[-1]}"
