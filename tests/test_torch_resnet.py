"""The port's ResNet against the JAX package's, on the CPU.

A tiny ResNet (``stage_sizes`` [1, 1] and [1, 1, 1, 1], 8 filters, 10
classes, batches of 8 32 x 32 images), both stems. The variables have
the flax model's shapes and flax's init recipe drawn from numpy (one
eval-mode test moves every scale and running statistic away from it),
carried into the port's module by ``models/convert.module_from_flax``.
Inputs come from numpy seeds. The JAX train step runs its loss as its own tests run
it on the CPU (the Pallas kernel in interpret mode).

Tolerances:
- float32 (the same arithmetic in other orders): logits ``rtol=1e-4,
  atol=1e-5``; running statistics after one train-mode forward within
  ``1e-5``; after 1 and 3 SGD(0.1, 0.9) steps the loss, every param and
  every running statistic within ``1e-4`` of its leaf's largest value.
- bf16 (both round every layer's output to bf16, at other points:
  XLA's fused BatchNorm against torch's; in train mode the last stage
  normalises 8 values a channel, which magnifies a rounding of its
  input): logits and running statistics within ``2^-5``
  (eight bf16 ulps) of the tensor's largest value; one SGD step's loss
  within ``2^-5``, and its update no further from the
  float32 update than twice the reference's own bf16 update (see
  ``test_bf16_sgd_step_as_close_to_float32_as_flax``).
"""

import functools

import flax.linen as fnn
import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from devspace_tpu.models.resnet import ResNet as JResNet
from devspace_tpu.training import trainer as jtrainer
from devspace_tpu_torch.models import layers
from devspace_tpu_torch.models.convert import module_from_flax, module_to_flax
from devspace_tpu_torch.models.resnet import ResNet as TResNet
from devspace_tpu_torch.training import trainer as ttrainer

F32_LOGITS = dict(rtol=1e-4, atol=1e-5)
F32_STATS_ATOL = 1e-5
F32_STEP_REL = 1e-4
BF16_REL = 2.0 ** -5
STEMS = ("conv7", "space_to_depth")
STAGES = ((1, 1), (1, 1, 1, 1))
LR, MOMENTUM = 0.1, 0.9


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


def images(seed=0, batch=8, size=32):
    rng = np.random.default_rng(seed)
    return (rng.normal(size=(batch, size, size, 3)).astype(np.float32),
            rng.integers(0, 10, size=batch))


DTYPES = {"f32": (jnp.float32, torch.float32), "bf16": (jnp.bfloat16, torch.bfloat16)}


@functools.lru_cache(maxsize=None)
def flax_model(stem, stages, dtype, active=False):
    """(flax module, variables of its shapes as numpy), made once per
    config (the values depend on the shapes alone: dtype is the compute
    type). flax's init recipe from a numpy seed: kernels normal with
    variance 1 / fan_in, BatchNorm scales 1 (each block's last one 0),
    biases 0, running means 0 and variances 1. ``active=True``: scales
    1 + |0.2 N|, biases and running means 0.1 N, variances 1 + |0.2 N|,
    so every residual branch and running statistic takes part."""
    jm = JResNet(stage_sizes=list(stages), num_classes=10, num_filters=8,
                 dtype=DTYPES[dtype][0], stem=stem)
    x, _ = images()
    shapes = jax.eval_shape(functools.partial(jm.init, train=False), jax.random.PRNGKey(0), x)
    rng = np.random.default_rng(0)

    def leaf(path, sd):
        keys = [p.key for p in path]
        name, shape = keys[-1], sd.shape
        if name == "kernel":
            return (rng.normal(size=shape) / np.sqrt(np.prod(shape[:-1]))).astype(np.float32)
        if active:
            if name in ("scale", "var"):
                return (1 + 0.2 * np.abs(rng.normal(size=shape))).astype(np.float32)
            return (0.1 * rng.normal(size=shape)).astype(np.float32)
        if name == "scale":
            return np.full(shape, 0.0 if "BatchNorm_2" in keys else 1.0, np.float32)
        return np.full(shape, 1.0 if name == "var" else 0.0, np.float32)

    return jm, jax.tree_util.tree_map_with_path(leaf, shapes)


@functools.lru_cache(maxsize=None)
def flax_step(stem, stages, dtype):
    """The reference's jitted SGD(0.1, 0.9) classifier step, once per config."""
    jm, _ = flax_model(stem, stages, dtype)
    return jtrainer.make_classifier_train_step(jm.apply, optax.sgd(LR, momentum=MOMENTUM),
                                               has_batch_stats=True, donate=False)


def pair(stem, stages, dtype, active=False):
    """(flax module, numpy variables, a new port module holding them)."""
    jm, variables = flax_model(stem, tuple(stages), dtype, active)
    tm = TResNet(stages, num_classes=10, num_filters=8, dtype=DTYPES[dtype][1], stem=stem,
                 device="cpu")
    return jm, variables, module_from_flax(tm, variables)


def rel_err(a, b) -> float:
    a, b = np.asarray(a, np.float32), np.asarray(b, np.float32)
    return float(np.abs(a - b).max() / max(np.abs(b).max(), 1e-30))


def assert_tree_rel(got: dict, want: dict, bound: float):
    flat_got = jax.tree_util.tree_leaves_with_path(got)
    flat_want = dict(jax.tree_util.tree_leaves_with_path(want))
    assert len(flat_got) == len(flat_want)
    for path, leaf in flat_got:
        err = rel_err(leaf, flat_want[path])
        assert err <= bound, (jax.tree_util.keystr(path), err)


@pytest.mark.parametrize("stages", STAGES, ids=["2stages", "4stages"])
@pytest.mark.parametrize("stem", STEMS)
def test_f32_logits_and_batch_stats_match_flax(stem, stages):
    jm, variables, tm = pair(stem, stages, "f32")
    x, _ = images()
    want_eval = np.asarray(jm.apply(variables, x, train=False))
    np.testing.assert_allclose(tm(torch.from_numpy(x), train=False).detach().numpy(),
                               want_eval, **F32_LOGITS)
    want_train, mutated = jm.apply(variables, x, train=True, mutable=["batch_stats"])
    got_train = tm(torch.from_numpy(x), train=True).detach().numpy()
    np.testing.assert_allclose(got_train, np.asarray(want_train), **F32_LOGITS)
    want_stats = jax.tree.map(np.asarray, mutated["batch_stats"])
    got_stats = module_to_flax(tm)["batch_stats"]
    jax.tree.map(lambda g, w: np.testing.assert_allclose(g, w, rtol=0, atol=F32_STATS_ATOL),
                 got_stats, want_stats)


@pytest.mark.parametrize("stages", STAGES, ids=["2stages", "4stages"])
@pytest.mark.parametrize("stem", STEMS)
def test_f32_eval_logits_match_flax_with_every_branch_active(stem, stages):
    """Eval mode over running statistics and scales away from their
    init: the residual branches and the running-average path all count."""
    jm, variables, tm = pair(stem, stages, "f32", active=True)
    x, _ = images(5)
    np.testing.assert_allclose(tm(torch.from_numpy(x), train=False).detach().numpy(),
                               np.asarray(jm.apply(variables, x, train=False)), **F32_LOGITS)


def run_steps(config, n):
    """n SGD(0.1, 0.9) classifier steps on both sides, the same batches;
    ``config`` is (stem, stages, dtype). Returns (losses, the reference's
    variables after them, the port's module)."""
    stem, stages, dtype = config
    _, variables, tm = pair(stem, stages, dtype)
    optimizer = optax.sgd(LR, momentum=MOMENTUM)
    jstate = {"params": variables["params"], "batch_stats": variables["batch_stats"],
              "opt_state": optimizer.init(variables["params"]), "step": jnp.zeros((), jnp.int32)}
    jstep = flax_step(stem, tuple(stages), dtype)
    tstate = ttrainer.init_train_state(tm, ttrainer.sgd(LR, MOMENTUM))
    tstep = ttrainer.make_classifier_train_step(tm, ttrainer.sgd(LR, MOMENTUM),
                                                has_batch_stats=True)
    losses = []
    for seed in range(n):
        x, y = images(seed + 1)
        jstate, jloss = jstep(jstate, {"image": jnp.asarray(x), "label": jnp.asarray(y)})
        tstate, tloss = tstep(tstate, {"image": torch.from_numpy(x), "label": torch.from_numpy(y)})
        losses.append((float(jloss), tloss.item()))
    assert tstate["step"] == n
    return losses, jax.tree.map(np.asarray, {"params": jstate["params"],
                                             "batch_stats": jstate["batch_stats"]}), tm


@pytest.mark.parametrize("n_steps", [1, 3])
@pytest.mark.parametrize("stem", STEMS)
def test_f32_sgd_steps_match_optax(stem, n_steps, pallas_interpret):
    losses, want, tm = run_steps((stem, (1, 1), "f32"), n_steps)
    for jl, tl in losses:
        assert abs(jl - tl) <= F32_STEP_REL * abs(jl), losses
    assert_tree_rel(module_to_flax(tm), want, F32_STEP_REL)


def update_dist(got: dict, want: dict, before: dict) -> float:
    """||(got - before) - (want - before)|| / ||want - before|| over every
    param: how far one step's update lies from another's."""
    num = den = 0.0
    for g, w, b in zip(*(jax.tree.leaves(t["params"]) for t in (got, want, before))):
        w, b = np.asarray(w, np.float32), np.asarray(b, np.float32)
        num += float(((np.asarray(g, np.float32) - w) ** 2).sum())
        den += float(((w - b) ** 2).sum())
    return (num / den) ** 0.5


@pytest.mark.parametrize("stem", STEMS)
def test_bf16_forward_within_the_stated_bound(stem):
    """bf16 compute, float32 params: logits (eval and train) and the
    running statistics, each within ``BF16_REL`` of its largest value."""
    jm, variables, tm = pair(stem, (1, 1, 1, 1), "bf16")
    x, _ = images()
    assert rel_err(tm(torch.from_numpy(x), train=False).detach().numpy(),
                   jm.apply(variables, x, train=False)) <= BF16_REL
    want, mutated = jm.apply(variables, x, train=True, mutable=["batch_stats"])
    got = tm(torch.from_numpy(x), train=True)
    assert got.dtype == torch.float32
    assert rel_err(got.detach().numpy(), want) <= BF16_REL
    assert_tree_rel(module_to_flax(tm)["batch_stats"],
                    jax.tree.map(np.asarray, mutated["batch_stats"]), BF16_REL)


@pytest.mark.parametrize("stem", STEMS)
def test_bf16_sgd_step_as_close_to_float32_as_flax(stem, pallas_interpret):
    """One bf16 SGD step. A BatchNorm scale or bias gradient sums
    thousands of bf16 terms that cancel, so either framework's bf16
    update already lies 8-22% (L2, over the params) from its float32
    update on this tiny net; elementwise parity is no bound here. Held:
    the loss within ``BF16_REL``, params and grads float32, and the
    port's update no further from the float32 one than twice the
    reference's own bf16 update is."""
    _, want32, _ = run_steps((stem, (1, 1), "f32"), 1)
    losses, want, tm = run_steps((stem, (1, 1), "bf16"), 1)
    before = flax_model(stem, (1, 1), "f32")[1]
    assert abs(losses[0][0] - losses[0][1]) <= BF16_REL * abs(losses[0][0]), losses
    for p in tm.parameters():
        assert p.dtype == torch.float32 and p.grad.dtype == torch.float32
    port = update_dist(module_to_flax(tm), want32, before)
    assert port <= 2 * update_dist(want, want32, before), port


def test_space_to_depth_stem_equals_the_conv7_stem():
    """The port of tests/test_models_ops.py's stem equivalence on the
    port's convolution: the 7x7/s2 weights mapped into the packed 4x4
    layout give the same output on the space-to-depth input."""
    b, h, w, c, o = 2, 32, 32, 3, 8
    rng = np.random.default_rng(0)
    x = torch.from_numpy(rng.normal(size=(b, h, w, c)).astype(np.float32))
    w7 = rng.normal(size=(7, 7, c, o)).astype(np.float32) * 0.1
    conv7 = layers.Conv(c, o, (7, 7), (2, 2), padding="SAME", device="cpu")
    assert conv7.pads(h, w) == ((2, 3), (2, 3))
    with torch.no_grad():
        conv7.kernel.copy_(torch.from_numpy(w7).permute(3, 2, 0, 1))
    ref = conv7(x.permute(0, 3, 1, 2))
    xp = (x.reshape(b, h // 2, 2, w // 2, 2, c).permute(0, 1, 3, 2, 4, 5)
          .reshape(b, h // 2, w // 2, 4 * c))
    w2 = np.zeros((4, 4, 4 * c, o), np.float32)
    for ry in range(4):
        for rx in range(4):
            for dy in range(2):
                for dx in range(2):
                    ky, kx = 2 * ry + dy, 2 * rx + dx
                    if ky < 7 and kx < 7:
                        sl = slice((dy * 2 + dx) * c, (dy * 2 + dx) * c + c)
                        w2[ry, rx, sl, :] = w7[ky, kx]
    conv4 = layers.Conv(4 * c, o, (4, 4), (1, 1), padding=((1, 2), (1, 2)), device="cpu")
    with torch.no_grad():
        conv4.kernel.copy_(torch.from_numpy(w2).permute(3, 2, 0, 1))
    out = conv4(xp.permute(0, 3, 1, 2))
    assert out.shape == ref.shape == (b, o, h // 2, w // 2)
    np.testing.assert_allclose(out.detach().numpy(), ref.detach().numpy(), rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("stride", [1, 2])
@pytest.mark.parametrize("kernel", [1, 3, 4, 7])
@pytest.mark.parametrize("size", [7, 8, 15, 16])
def test_same_padding_matches_xla(size, kernel, stride):
    """flax's SAME split (lo = total // 2) against XLA's own, through the
    port's convolution, on odd and even sizes."""
    rng = np.random.default_rng(size * 100 + kernel * 10 + stride)
    x = rng.normal(size=(2, size, size + 1, 3)).astype(np.float32)
    w = rng.normal(size=(kernel, kernel, 3, 5)).astype(np.float32)
    want = jax.lax.conv_general_dilated(
        x, w, (stride, stride), "SAME", dimension_numbers=("NHWC", "HWIO", "NHWC"))
    conv = layers.Conv(3, 5, (kernel, kernel), (stride, stride), device="cpu")
    with torch.no_grad():
        conv.kernel.copy_(torch.from_numpy(w).permute(3, 2, 0, 1))
    got = conv(torch.from_numpy(x).permute(0, 3, 1, 2)).permute(0, 2, 3, 1)
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want), rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("stride", [1, 2])
@pytest.mark.parametrize("size", [7, 8, 15, 16])
def test_max_pool_same_matches_flax(size, stride):
    """``max_pool_same`` pads with -inf on flax's split: equal to
    ``flax.linen.max_pool(..., padding="SAME")``, negative inputs
    included."""
    x = np.random.default_rng(size + stride).normal(size=(2, size, size, 3)).astype(np.float32) - 3
    want = fnn.max_pool(jnp.asarray(x), (3, 3), strides=(stride, stride), padding="SAME")
    got = layers.max_pool_same(torch.from_numpy(x).permute(0, 3, 1, 2), 3, stride)
    np.testing.assert_array_equal(got.permute(0, 2, 3, 1).numpy(), np.asarray(want))


def test_module_names_and_round_trip():
    """Every flax variable maps one to one onto the port's names, and
    back: ResNet-50's tree (shapes only) and a tiny tree's values."""
    jm = JResNet(stage_sizes=[3, 4, 6, 3], num_classes=1000, stem="space_to_depth")
    shapes = jax.eval_shape(lambda: jm.init(jax.random.PRNGKey(0), jnp.zeros((1, 64, 64, 3)),
                                            train=False))
    tm = TResNet([3, 4, 6, 3], stem="space_to_depth", device="cpu")
    got = {k: tuple(v.shape) for k, v in tm.state_dict().items()}
    want = {}
    for path, leaf in jax.tree_util.tree_leaves_with_path(shapes):
        name = ".".join(p.key for p in path[1:])
        s = tuple(leaf.shape)
        want[name] = (s[3], s[2], s[0], s[1]) if len(s) == 4 else s
    assert got == want
    assert sum(p.numel() for p in tm.parameters()) == 25_557_032 + 2_880  # s2d stem: 12 in
    _, variables, tm = pair("conv7", (1, 1), "f32")
    back = module_to_flax(tm)
    jax.tree.map(np.testing.assert_array_equal, back, variables)


def test_classifier_step_checks_the_batch_stats_flag():
    tm = TResNet([1], num_classes=10, num_filters=8, dtype=torch.float32, device="cpu")
    with pytest.raises(ValueError, match="has_batch_stats=False"):
        ttrainer.make_classifier_train_step(tm, ttrainer.sgd(LR), has_batch_stats=False)
