"""The port's MLP, its synthetic data and input pipeline, and the SGD
factory, against the JAX package's and optax, on the CPU.

Tolerances: MLP logits float32 ``rtol=1e-5, atol=1e-6`` (three products
summed in other orders); after 3 Adam(1e-3) steps the losses
``rtol=1e-5`` and the params within ``1e-4`` (a tenth of one step, as in
tests/test_torch_vit.py); SGD with momentum against optax on the same
gradients ``rtol=1e-6`` (the same two float32 operations an element).
The synthetic data are byte-equal.
"""

import collections
import itertools

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch
from torch.utils.data import DataLoader, TensorDataset

from devspace_tpu.models.mlp import MLP as JMLP
from devspace_tpu.training import data as jdata
from devspace_tpu.training import trainer as jtrainer
from devspace_tpu_torch.models.convert import module_from_flax, module_to_flax
from devspace_tpu_torch.models.mlp import MLP as TMLP
from devspace_tpu_torch.training import data as tdata
from devspace_tpu_torch.training import trainer as ttrainer

LOGITS = dict(rtol=1e-5, atol=1e-6)


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


def mlp_pair(features=(64, 32, 10)):
    jm = JMLP(features=features)
    x = np.zeros((1, 28, 28, 1), np.float32)
    variables = jax.tree.map(np.asarray, jax.jit(jm.init)(jax.random.PRNGKey(0), x))
    tm = TMLP(features=features, device="cpu")
    return jm, variables, module_from_flax(tm, variables)


def test_mlp_logits_match_flax():
    jm, variables, tm = mlp_pair()
    batch = next(jdata.synthetic_mnist(8, seed=1))
    want = np.asarray(jm.apply(variables, batch["image"]))
    got = tm(torch.from_numpy(np.array(batch["image"])))
    assert got.shape == (8, 10) and got.dtype == torch.float32
    np.testing.assert_allclose(got.detach().numpy(), want, **LOGITS)
    names = [n for n, _ in tm.named_parameters()]
    assert names == [f"Dense_{i}.{p}" for i in range(3) for p in ("kernel", "bias")]


def test_mlp_adam_steps_match_optax(pallas_interpret):
    jm, variables, tm = mlp_pair()
    optimizer = optax.adam(1e-3)
    jstate = {"params": variables["params"], "opt_state": optimizer.init(variables["params"]),
              "step": jnp.zeros((), jnp.int32)}
    jstep = jtrainer.make_classifier_train_step(jm.apply, optimizer, donate=False)
    tstate = ttrainer.init_train_state(tm, ttrainer.adam(1e-3))
    tstep = ttrainer.make_classifier_train_step(tm, ttrainer.adam(1e-3))
    jbatches = jdata.synthetic_mnist(16, seed=2)
    tbatches = tdata.synthetic_mnist(16, seed=2, device="cpu")
    for _ in range(3):
        jstate, jloss = jstep(jstate, next(jbatches))
        tstate, tloss = tstep(tstate, next(tbatches))
        np.testing.assert_allclose(tloss.item(), float(jloss), rtol=1e-5)
    jax.tree.map(lambda g, w: np.testing.assert_allclose(g, np.asarray(w), rtol=0, atol=1e-4),
                 module_to_flax(tm)["params"], jstate["params"])
    assert tstate["step"] == 3


@pytest.mark.parametrize("momentum", [0.9, 0.5])
def test_sgd_is_optax_sgd_with_momentum(momentum):
    """``sgd(lr, momentum)`` (torch.optim.SGD, dampening 0) applies
    optax.sgd's trace update ``t = g + m t; p -= lr t`` on the same
    gradients, from the first step on."""
    rng = np.random.default_rng(0)
    p0 = rng.normal(size=(5, 3)).astype(np.float32)
    grads = [rng.normal(size=(5, 3)).astype(np.float32) for _ in range(4)]
    opt = optax.sgd(0.1, momentum=momentum)
    jp, state = jnp.asarray(p0), opt.init(jnp.asarray(p0))
    tp = torch.tensor(p0, requires_grad=True)
    topt = ttrainer.sgd(0.1, momentum)([tp])
    for g in grads:
        updates, state = opt.update(jnp.asarray(g), state, jp)
        jp = optax.apply_updates(jp, updates)
        tp.grad = torch.from_numpy(g)
        topt.step()
        np.testing.assert_allclose(tp.detach().numpy(), np.asarray(jp), rtol=1e-6, atol=1e-7)
    assert topt.defaults["dampening"] == 0 and not topt.defaults["nesterov"]


@pytest.mark.parametrize("seed", [0, 3])
def test_synthetic_mnist_is_byte_equal(seed):
    j, t = jdata.synthetic_mnist(5, seed=seed), tdata.synthetic_mnist(5, seed=seed, device="cpu")
    for _ in range(3):
        a, b = next(j), next(t)
        assert b["image"].dtype == torch.float32 and b["label"].dtype == torch.int64
        assert b["image"].shape == (5, 28, 28, 1)
        np.testing.assert_array_equal(b["image"].numpy(), np.asarray(a["image"]))
        np.testing.assert_array_equal(b["label"].numpy(), np.asarray(a["label"]))


@pytest.mark.parametrize("seed, size, classes", [(0, 16, 1000), (7, 8, 10)])
def test_synthetic_imagenet_is_byte_equal(seed, size, classes):
    j = jdata.synthetic_imagenet(3, image_size=size, num_classes=classes, seed=seed)
    t = tdata.synthetic_imagenet(3, image_size=size, num_classes=classes, seed=seed, device="cpu")
    for _ in range(2):
        a, b = next(j), next(t)
        assert b["image"].shape == (3, size, size, 3) and b["label"].dtype == torch.int64
        np.testing.assert_array_equal(b["image"].numpy(), np.asarray(a["image"]))
        np.testing.assert_array_equal(b["label"].numpy(), np.asarray(a["label"]))


@pytest.mark.parametrize("seed, active", [(0, 256), (5, 64)])
def test_markov_tokens_is_byte_equal(seed, active):
    j = jdata.markov_tokens(2, 17, active=active, seed=seed)
    t = tdata.markov_tokens(2, 17, active=active, seed=seed, device="cpu")
    for _ in range(3):
        a, b = next(j), next(t)
        assert b.dtype == torch.int64
        np.testing.assert_array_equal(b.numpy(), np.asarray(a))


@pytest.mark.parametrize("index, count, want", [
    (0, 1, [0, 1, 2, 3, 4, 5, 6, 7]),
    (0, 2, [0, 1, 2, 3]),
    (1, 2, [4, 5, 6, 7]),
    (3, 4, [6, 7]),
])
def test_host_shard_slices_this_process(index, count, want):
    batch = {"image": torch.arange(8).view(8, 1) * 10, "label": np.arange(8)}
    part = tdata.host_shard(batch, index, count)
    np.testing.assert_array_equal(part["label"], want)
    np.testing.assert_array_equal(part["image"][:, 0].numpy(), np.asarray(want) * 10)
    jpart = jdata.host_shard({"label": np.arange(8)}, index, count)
    np.testing.assert_array_equal(part["label"], jpart["label"])


def test_host_shard_refuses_an_indivisible_batch():
    with pytest.raises(ValueError, match="not divisible by 3 hosts"):
        tdata.host_shard({"x": torch.zeros(8, 2)}, 0, 3)


def test_host_shard_defaults_to_one_process_and_reads_torch_distributed(monkeypatch):
    batch = (torch.arange(6), [torch.arange(6) * 2])
    whole = tdata.host_shard(batch)
    assert isinstance(whole, tuple) and isinstance(whole[1], list)
    assert whole[0].tolist() == list(range(6))
    dist = torch.distributed
    monkeypatch.setattr(dist, "is_initialized", lambda: True)
    monkeypatch.setattr(dist, "get_rank", lambda: 1)
    monkeypatch.setattr(dist, "get_world_size", lambda: 3)
    assert tdata.host_shard(batch)[1][0].tolist() == [4, 6]
    assert tdata.host_shard(batch, 0, 2)[0].tolist() == [0, 1, 2]


def test_prefetch_to_device_keeps_order_and_size_in_flight():
    pulled = []

    def source(n):
        for i in range(n):
            pulled.append(i)
            yield {"x": np.full(3, i), "y": (torch.tensor([i]),)}

    seen = []
    for batch in tdata.prefetch_to_device(source(5), size=3, device="cpu"):
        seen.append(int(batch["x"][0]))
        assert isinstance(batch["x"], torch.Tensor) and isinstance(batch["y"], tuple)
        # three batches are in flight when the first is handed out
        assert len(pulled) == min(5, seen[-1] + 3)
    assert seen == [0, 1, 2, 3, 4]
    with pytest.raises(ValueError):
        next(tdata.prefetch_to_device(source(1), size=0, device="cpu"))


def test_prefetch_to_device_goes_to_the_card_by_default():
    if torch.cuda.is_available():
        pytest.skip("checks the refusal on a machine without CUDA")
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        next(tdata.prefetch_to_device(iter([{"x": np.zeros(1)}])))


def test_from_torch_adapts_a_dataloader():
    ds = TensorDataset(torch.arange(10).float().view(10, 1), torch.arange(10))
    batches = list(tdata.from_torch(DataLoader(ds, batch_size=4)))
    assert [len(b[1]) for b in batches] == [4, 4, 2]
    assert isinstance(batches[0], list) and batches[0][1].dtype == torch.int64
    Pair = collections.namedtuple("Pair", "image label")
    out = next(tdata.from_torch([{"a": np.ones(2), "b": Pair(np.zeros(1), 3)}]))
    assert isinstance(out["b"], Pair) and out["b"].label.item() == 3
    assert all(isinstance(t, torch.Tensor) for t in (out["a"], out["b"].image))
    # the pipeline the JAX example builds: adapt, shard, prefetch
    piped = list(tdata.prefetch_to_device(
        (tdata.host_shard(b, 0, 2) for b in itertools.islice(
            tdata.from_torch(DataLoader(ds, batch_size=4, drop_last=True)), 2)),
        size=2, device="cpu"))
    assert [p[1].tolist() for p in piped] == [[0, 1], [4, 5]]
