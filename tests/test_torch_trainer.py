"""The port's LM training slice as a whole vs the JAX package's: the train
step (forward, fused loss, AdamW), gradient accumulation and the data.

float32 TINY, JAX params carried across through numpy, ``[2, 65]`` token
batches from ``markov_sampler`` (byte-identical on both sides). The JAX
step runs under interpret mode, so its attention and loss are its
Pallas kernels; the port runs its plain versions on the CPU.
Tolerances (float32, the same math in another order): loss
``atol=1e-5``; every grad leaf ``rtol=1e-4, atol=1e-6``. Params after 3
AdamW steps: AdamW divides each gradient by its own running RMS, so an
element whose gradient sits near float32 noise can take a different
fraction of its step (at most about lr = 3e-4). Every element is held
to ``atol=3e-5`` (a tenth of one step) and all but one in a thousand to
``atol=1e-6``.
"""

import dataclasses
import inspect

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from devspace_tpu.models import transformer as jtfm
from devspace_tpu.ops.losses import fused_cross_entropy as jxent
from devspace_tpu.training import data as jdata
from devspace_tpu.training import trainer as jtrainer
from devspace_tpu_torch.models import transformer as ttfm
from devspace_tpu_torch.models.convert import params_from_numpy, params_to_numpy
from devspace_tpu_torch.training import data as tdata
from devspace_tpu_torch.training import trainer as ttrainer

LOSS_ATOL = 1e-5
GRAD_TOL = dict(rtol=1e-4, atol=1e-6)
PARAM_ATOL, PARAM_ATOL_MOST = 3e-5, 1e-6
LR = 3e-4


@pytest.fixture(scope="module")
def model():
    jcfg = dataclasses.replace(jtfm.TINY, dtype=jnp.float32)
    tcfg = dataclasses.replace(ttfm.TINY, dtype=torch.float32)
    jparams = jtfm.init_params(jcfg, jax.random.PRNGKey(0))
    return jcfg, tcfg, jparams


@pytest.fixture
def pallas_interpret(monkeypatch):
    monkeypatch.setenv("DEVSPACE_PALLAS_INTERPRET", "1")


def batches(n):
    sample = tdata.markov_sampler(device="cpu")
    return [sample(2, 65, seed=s) for s in range(1, n + 1)]


def leaves(tree):
    return jax.tree_util.tree_leaves(tree)


def port_state(jparams):
    params = params_from_numpy(jax.tree.map(np.asarray, jparams), "cpu", trainable=True)
    return ttrainer.init_train_state(params, ttrainer.adamw(LR))


def jax_loss(jcfg):
    def loss_fn(params, tokens):
        logits = jtfm.forward(params, tokens[:, :-1], jcfg)
        b, t, v = logits.shape
        return jnp.mean(jxent(logits.reshape(b * t, v), tokens[:, 1:].reshape(-1)))

    return loss_fn


def test_markov_corpus_is_byte_identical_to_jax():
    got = tdata.markov_sampler(active=64, seed=3, device="cpu")(4, 40, seed=9)
    ref = jdata.markov_sampler(active=64, seed=3)(4, 40, seed=9)
    assert got.dtype == torch.int64 and got.device.type == "cpu"
    np.testing.assert_array_equal(got.numpy(), ref)
    tok = next(tdata.synthetic_tokens(2, 8, 100, seed=5, device="cpu"))
    np.testing.assert_array_equal(tok.numpy(), np.asarray(next(jdata.synthetic_tokens(2, 8, 100, seed=5))))


def test_adamw_defaults_match_optax():
    """optax.adamw defaults to weight decay 1e-4; torch.optim.AdamW to
    1e-2. The port's factory must carry optax's values."""
    sig = inspect.signature(optax.adamw).parameters
    opt = ttrainer.adamw(LR)([torch.zeros(2, requires_grad=True)])
    group = opt.param_groups[0]
    assert isinstance(opt, torch.optim.AdamW)
    assert group["lr"] == LR
    assert group["betas"] == (sig["b1"].default, sig["b2"].default)
    assert group["eps"] == sig["eps"].default and sig["eps_root"].default == 0.0
    assert group["weight_decay"] == sig["weight_decay"].default == 1e-4
    assert inspect.signature(torch.optim.AdamW).parameters["weight_decay"].default != 1e-4


def test_one_step_loss_and_grads_match_jax(model, pallas_interpret):
    jcfg, tcfg, jparams = model
    (tok,) = batches(1)
    jtok = jnp.asarray(tok.numpy(), jnp.int32)
    jl, jgrads = jax.value_and_grad(jax_loss(jcfg))(jparams, jtok)
    opt = optax.adamw(LR)
    jstep = jtrainer.make_lm_train_step(jtfm.forward, jcfg, opt, donate=False)
    _, jstep_loss = jstep({"params": jparams, "opt_state": opt.init(jparams),
                           "step": jnp.zeros((), jnp.int32)}, jtok)
    np.testing.assert_allclose(float(jstep_loss), float(jl), atol=1e-7)

    step = ttrainer.make_lm_train_step(ttfm.forward, tcfg, ttrainer.adamw(LR))
    state, loss = step(port_state(jparams), tok)
    assert state["step"] == 1 and loss.dtype == torch.float32
    np.testing.assert_allclose(loss.item(), float(jl), atol=LOSS_ATOL)
    tgrads = params_to_numpy(ttrainer.tree_like(
        state["params"], [p.grad for p in ttrainer.param_leaves(state["params"])]))
    jflat, tflat = leaves(jgrads), leaves(tgrads)
    assert len(jflat) == len(tflat) == 3 + 9 * jcfg.n_layers
    for i, (got, ref) in enumerate(zip(tflat, jflat)):
        np.testing.assert_allclose(got, np.asarray(ref), err_msg=f"grad leaf {i}", **GRAD_TOL)


def test_three_steps_params_match_jax(model, pallas_interpret):
    jcfg, tcfg, jparams = model
    toks = batches(3)
    opt = optax.adamw(LR)
    jstep = jtrainer.make_lm_train_step(jtfm.forward, jcfg, opt, donate=False)
    jstate = {"params": jparams, "opt_state": opt.init(jparams), "step": jnp.zeros((), jnp.int32)}
    jstate, jloss = jtrainer.train_loop(
        jstep, jstate, [jnp.asarray(t.numpy(), jnp.int32) for t in toks])

    step = ttrainer.make_lm_train_step(ttfm.forward, tcfg, ttrainer.adamw(LR))
    saves = []

    class Manager:  # the duck-typed checkpoint manager of train_loop
        def maybe_save(self, step, state):
            saves.append(step)

    state, loss = ttrainer.train_loop(step, port_state(jparams), toks, checkpoint_manager=Manager())
    assert saves == [1, 2, 3] and state["step"] == 3
    np.testing.assert_allclose(loss.item(), float(jloss), atol=LOSS_ATOL)
    for i, (got, ref) in enumerate(zip(leaves(params_to_numpy(state["params"])),
                                       leaves(jstate["params"]))):
        np.testing.assert_allclose(got, np.asarray(ref), atol=PARAM_ATOL, rtol=0,
                                   err_msg=f"param leaf {i}")
        assert np.mean(np.abs(got - np.asarray(ref)) > PARAM_ATOL_MOST) < 1e-3, i


def test_accumulate_gradients_matches_jax(model, pallas_interpret):
    jcfg, tcfg, jparams = model
    micro = torch.stack(batches(2))  # [2 microbatches, 2, 65]
    jloss, jgrads = jtrainer.accumulate_gradients(jax_loss(jcfg), 2)(
        jparams, jnp.asarray(micro.numpy(), jnp.int32))
    params = port_state(jparams)["params"]
    loss, grads = ttrainer.accumulate_gradients(ttrainer.lm_loss(ttfm.forward, tcfg), 2)(
        params, micro)
    np.testing.assert_allclose(loss.item(), float(jloss), atol=LOSS_ATOL)
    for i, (got, ref) in enumerate(zip(leaves(params_to_numpy(grads)), leaves(jgrads))):
        np.testing.assert_allclose(got, np.asarray(ref), err_msg=f"grad leaf {i}", **GRAD_TOL)
