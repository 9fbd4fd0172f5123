"""The port's ViT against the JAX package's, on the CPU.

A tiny ViT (patch 4, hidden 32, depth 2, 4 heads, mlp 64, 16 x 16 images,
10 classes). The variables have the flax model's shapes and numpy-seeded
values (every bias, scale and the cls token away from zero), carried
into the port's module by ``models/convert.module_from_flax``. The JAX
train step runs its loss as its own tests run it on the CPU (the Pallas
kernel in interpret mode).

Tolerances:
- float32 (the same arithmetic in other orders): logits ``rtol=1e-4,
  atol=1e-5``; after 3 Adam(1e-3) steps the losses ``rtol=1e-5`` and
  every param within ``1e-4`` (a tenth of one step: Adam divides each
  gradient by its own running RMS, so an element whose gradient sits at
  float32 noise may take another fraction of its step), but the key
  biases: the softmax cancels them, their gradient is float32 noise, and
  both sides are held to at most 3 steps of lr from where they started.
- bf16 (flax rounds after every op of the softmax and GELU, torch inside
  some of its fused ops): logits within ``2^-6`` (four bf16 ulps) of
  their largest value.
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from devspace_tpu.models.vit import ViT as JViT
from devspace_tpu.training import trainer as jtrainer
from devspace_tpu_torch.models import vit as tvit
from devspace_tpu_torch.models.convert import module_from_flax, module_to_flax
from devspace_tpu_torch.training import trainer as ttrainer

F32_LOGITS = dict(rtol=1e-4, atol=1e-5)
LOSS_RTOL = 1e-5
PARAM_ATOL = 1e-4
BF16_REL = 2.0 ** -6
TINY = dict(num_classes=10, patch_size=4, hidden_dim=32, depth=2, num_heads=4, mlp_dim=64)
DTYPES = {"f32": (jnp.float32, torch.float32), "bf16": (jnp.bfloat16, torch.bfloat16)}


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


def batch(seed=0, n=4, size=16, classes=10):
    rng = np.random.default_rng(seed)
    return (rng.normal(size=(n, size, size, 3)).astype(np.float32),
            rng.integers(0, classes, size=n))


@functools.lru_cache(maxsize=None)
def flax_variables(size=16, cfg=tuple(TINY.items())):
    """Numpy variables of the flax ViT's shapes: kernels normal with
    variance 1 / fan_in, biases 0.1 N, LayerNorm scales 1 + 0.2 N, cls
    and pos_embed 0.02 N."""
    jm = JViT(**dict(cfg))
    shapes = jax.eval_shape(functools.partial(jm.init, train=False), jax.random.PRNGKey(0),
                            jnp.zeros((1, size, size, 3)))
    rng = np.random.default_rng(0)

    def leaf(path, sd):
        name, shape = path[-1].key, sd.shape
        if name == "kernel":
            fan_in = np.prod(shape[:-2]) if path[-2].key == "out" else np.prod(shape[:-1])
            if path[-2].key in ("query", "key", "value"):
                fan_in = shape[0]
            return (rng.normal(size=shape) / np.sqrt(fan_in)).astype(np.float32)
        if name == "scale":
            return (1 + 0.2 * rng.normal(size=shape)).astype(np.float32)
        scale = 0.02 if name in ("cls", "pos_embed") else 0.1
        return (scale * rng.normal(size=shape)).astype(np.float32)

    return jax.tree_util.tree_map_with_path(leaf, shapes)


def pair(dtype, size=16, **over):
    cfg = {**TINY, **over}
    variables = flax_variables(size, tuple(cfg.items()))
    jm = JViT(**cfg, dtype=DTYPES[dtype][0])
    tm = tvit.ViT(**cfg, dtype=DTYPES[dtype][1], image_size=size, device="cpu")
    return jm, variables, module_from_flax(tm, variables)


def test_f32_logits_match_flax():
    jm, variables, tm = pair("f32")
    x, _ = batch()
    want = np.asarray(jm.apply(variables, x, train=False))
    got = tm(torch.from_numpy(x), train=False)
    assert got.dtype == torch.float32 and got.shape == (4, 10)
    np.testing.assert_allclose(got.detach().numpy(), want, **F32_LOGITS)
    assert tm.pos_embed.shape == (1, 17, 32)  # 4 x 4 patches and the cls token


def test_bf16_logits_within_the_stated_bound():
    jm, variables, tm = pair("bf16")
    x, _ = batch(1)
    want = np.asarray(jm.apply(variables, x, train=False), np.float32)
    got = tm(torch.from_numpy(x)).detach().numpy()
    assert np.abs(got - want).max() <= BF16_REL * np.abs(want).max()


def test_softmax_in_dtype_is_jax_softmax():
    """The attention softmax in bf16, as jax.nn.softmax computes it."""
    s = np.random.default_rng(2).normal(size=(3, 5, 7)).astype(np.float32) * 4
    for jdtype, tdtype in DTYPES.values():
        want = np.asarray(jax.nn.softmax(jnp.asarray(s, jdtype)), np.float32)
        got = tvit.softmax_in_dtype(torch.from_numpy(s).to(tdtype)).float().numpy()
        np.testing.assert_allclose(got, want, rtol=0, atol=float(jnp.finfo(jdtype).eps))


def test_three_adam_steps_match_optax(pallas_interpret):
    jm, variables, tm = pair("f32")
    optimizer = optax.adam(1e-3)
    jstate = {"params": variables["params"], "opt_state": optimizer.init(variables["params"]),
              "step": jnp.zeros((), jnp.int32)}
    jstep = jtrainer.make_classifier_train_step(jm.apply, optimizer, donate=False)
    tstate = ttrainer.init_train_state(tm, ttrainer.adam(1e-3))
    tstep = ttrainer.make_classifier_train_step(tm, ttrainer.adam(1e-3))
    for seed in range(3):
        x, y = batch(seed + 10)
        jstate, jloss = jstep(jstate, {"image": jnp.asarray(x), "label": jnp.asarray(y)})
        tstate, tloss = tstep(tstate, {"image": torch.from_numpy(x), "label": torch.from_numpy(y)})
        np.testing.assert_allclose(tloss.item(), float(jloss), rtol=LOSS_RTOL)
    want = dict(jax.tree_util.tree_leaves_with_path(jstate["params"]))
    start = dict(jax.tree_util.tree_leaves_with_path(variables["params"]))
    for path, got in jax.tree_util.tree_leaves_with_path(module_to_flax(tm)["params"]):
        if [p.key for p in path[-2:]] == ["key", "bias"]:
            # a key bias shifts every score of a query row alike, which
            # the softmax cancels: its gradient is float32 noise, which
            # Adam scales to steps of up to lr either way
            for side in (got, np.asarray(want[path])):
                assert np.abs(side - start[path]).max() <= 3 * 1e-3 * (1 + 1e-3)
            continue
        np.testing.assert_allclose(got, np.asarray(want[path]), rtol=0, atol=PARAM_ATOL,
                                   err_msg=jax.tree_util.keystr(path))


def test_vit_train_step_learns():
    """The port of tests/test_models_ops.py::test_vit_train_step_learns:
    ViT (depth 1, 2 heads, 4 classes) at 8 x 8, Adam(1e-2) on one batch of
    16: the loss after 30 more steps is below the first."""
    model = tvit.ViT(num_classes=4, patch_size=4, hidden_dim=32, depth=1, num_heads=2,
                     mlp_dim=64, dtype=torch.float32, image_size=8, device="cpu")
    rng = np.random.default_rng(0)
    images = torch.from_numpy(rng.normal(size=(16, 8, 8, 3)).astype(np.float32))
    labels = torch.from_numpy(rng.integers(0, 4, size=16))
    state = ttrainer.init_train_state(model, ttrainer.adam(1e-2))
    step = ttrainer.make_classifier_train_step(model, ttrainer.adam(1e-2), has_batch_stats=False)
    batch_ = {"image": images, "label": labels}
    state, loss0 = step(state, batch_)
    for _ in range(30):
        state, loss = step(state, batch_)
    assert loss.item() < loss0.item()


def test_vit_names_match_flax_at_vit_b16():
    """ViT-B/16's variable names and shapes at 224^2, one to one."""
    jm = JViT(hidden_dim=768, depth=12, num_heads=12, mlp_dim=3072)
    shapes = jax.eval_shape(functools.partial(jm.init, train=False), jax.random.PRNGKey(0),
                            jnp.zeros((1, 224, 224, 3)))
    tm = tvit.ViT_B16(device="cpu")
    got = {k: tuple(v.shape) for k, v in tm.state_dict().items()}
    want = {}
    for path, leaf in jax.tree_util.tree_leaves_with_path(shapes):
        s = tuple(leaf.shape)
        want[".".join(p.key for p in path[1:])] = (s[3], s[2], s[0], s[1]) if len(s) == 4 else s
    assert got == want
    assert sum(p.numel() for p in tm.parameters()) == 86_567_656
