"""Train states of the port's classifiers through checkpoints, optimizer
moments bound by name, and gradient accumulation over a module, on the
CPU.

- A classifier's train state is ``{"params": <module>, ...}``: it is
  checkpointed through the module's ``state_dict`` (BatchNorm running
  statistics included) and restored in place; a run resumed at step 1
  equals an uninterrupted 2-step run bit for bit.
- The optimizer's moments are saved with the parameter names in
  optimizer order: a state built in another leaf order (the order
  ``param_leaves`` listed before it sorted dict keys, written out below)
  is remapped onto the right parameters on restore, also where two
  leaves of one shape swap places; a version 1 train state, which named
  nothing, is refused, and a version 1 bare params tree still loads.
- ``accumulate_gradients`` over the flax MLP's port equals the mean of
  ``jax.grad`` over the same two microbatches, float32 within 1e-6
  relative.
"""

import dataclasses
import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from devspace_tpu.models.mlp import MLP as JMLP
from devspace_tpu_torch.inference import load_serving_params
from devspace_tpu_torch.models import transformer as tfm
from devspace_tpu_torch.models.convert import module_from_flax
from devspace_tpu_torch.models.mlp import MLP
from devspace_tpu_torch.models.resnet import ResNet
from devspace_tpu_torch.training import checkpoint as ckpt
from devspace_tpu_torch.training import trainer
from devspace_tpu_torch.training.data import synthetic_mnist

F32 = dataclasses.replace(tfm.TINY, dtype=torch.float32)


@pytest.fixture(autouse=True)
def few_torch_threads():
    n = torch.get_num_threads()
    torch.set_num_threads(min(n, 2))
    yield
    torch.set_num_threads(n)


def resnet():
    return ResNet([1, 1], num_classes=10, num_filters=8, device="cpu")


MODELS = {
    # ResNet's stem takes three channels: the gray image is repeated
    "resnet": (resnet, True, lambda b: {**b, "image": b["image"].repeat(1, 1, 1, 3)}),
    "mlp": (lambda: MLP(device="cpu"), False, lambda b: b),
}


def mnist_batches(n, prep):
    it = synthetic_mnist(8, device="cpu")
    return [prep(next(it)) for _ in range(n)]


def classifier_state(name):
    make, stats, _ = MODELS[name]
    model = make()
    state = trainer.init_train_state(model, trainer.adam(1e-3))
    return state, trainer.make_classifier_train_step(model, has_batch_stats=stats)


def assert_state_equal(a, b):
    sa, sb = a["params"].state_dict(), b["params"].state_dict()
    assert list(sa) == list(sb)
    for k in sa:
        assert torch.equal(sa[k].view(torch.uint8), sb[k].view(torch.uint8)), k
    oa, ob = a["opt_state"].state_dict()["state"], b["opt_state"].state_dict()["state"]
    assert set(oa) == set(ob)
    for i in oa:
        for key in oa[i]:
            assert torch.equal(oa[i][key], ob[i][key]), (i, key)


@pytest.mark.parametrize("name", sorted(MODELS))
def test_classifier_train_state_checkpoints_and_resumes(tmp_path, name):
    prep = MODELS[name][2]
    batches = mnist_batches(2, prep)
    state, step_fn = classifier_state(name)
    with ckpt.CheckpointManager(str(tmp_path), save_interval=1) as mgr:
        full, _ = trainer.train_loop(step_fn, state, batches, checkpoint_manager=mgr)
    assert mgr.all_steps() == [1, 2]
    meta = ckpt.read_meta(os.path.join(str(tmp_path), "step_00000002"))
    assert meta["version"] == ckpt.VERSION == 2
    assert meta["opt_names"] == [n for n, _ in full["params"].named_parameters()]

    # restore the last step into a fresh state: every entry of the
    # module's state_dict (running statistics too) equals the live one
    back, _ = classifier_state(name)
    got = mgr.restore(2, back)
    assert got["step"] == 2 and got["params"] is back["params"]
    assert_state_equal(got, full)
    if name == "resnet":
        stats = [k for k in full["params"].state_dict() if k.endswith((".mean", ".var"))]
        assert stats and all(
            torch.equal(got["params"].state_dict()[k], full["params"].state_dict()[k])
            for k in stats)

    # resume at step 1 and take the second step: bit for bit the same run
    resumed, _ = classifier_state(name)
    resumed = mgr.restore(1, resumed)
    assert resumed["step"] == 1
    step_fn = trainer.make_classifier_train_step(resumed["params"],
                                                 has_batch_stats=MODELS[name][1])
    resumed, _ = trainer.train_loop(step_fn, resumed, batches[1:], start_step=1)
    assert resumed["step"] == 2
    assert_state_equal(resumed, full)


def pr9_param_leaves(params):
    """``param_leaves`` as it listed a transformer's leaves before it
    sorted dict keys: embed, each layer's entries in insertion order,
    final_norm, lm_head."""
    return ([params["embed"]]
            + [t for layer in params["layers"] for t in layer.values()]
            + [params["final_norm"], params["lm_head"]])


def lm_state(order):
    params = tfm.init_params(F32, torch.Generator().manual_seed(0))
    for p in trainer.param_leaves(params):
        p.requires_grad_()
    opt = trainer.adamw(1e-2)(order(params))
    return {"params": params, "opt_state": opt, "step": 0}


def leaf_names(tree, prefix=""):
    if isinstance(tree, dict):
        return {k: v for key in tree for k, v in leaf_names(tree[key], f"{prefix}{key}.").items()}
    if isinstance(tree, list):
        return {k: v for i, t in enumerate(tree) for k, v in leaf_names(t, f"{prefix}{i}.").items()}
    return {id(tree): prefix[:-1]}


def moments_by_name(state):
    by_id = leaf_names(state["params"])
    names = [by_id[id(p)] for g in state["opt_state"].param_groups for p in g["params"]]
    sd = state["opt_state"].state_dict()["state"]
    return {n: sd[i]["exp_avg_sq"] for i, n in enumerate(names)}


def one_step(state):
    tokens = torch.randint(1, F32.vocab_size, (2, 17), generator=torch.Generator().manual_seed(1))
    return trainer.make_lm_train_step(tfm.forward, F32, None)(state, tokens)[0]


def test_moments_saved_in_another_order_are_remapped_by_name(tmp_path):
    old = one_step(lm_state(pr9_param_leaves))
    assert [t.shape for t in pr9_param_leaves(old["params"])] != [
        t.shape for t in trainer.param_leaves(old["params"])]
    ckpt.save_checkpoint(str(tmp_path / "s"), old)
    template = trainer.init_train_state(lm_state(trainer.param_leaves)["params"],
                                        trainer.adamw(1e-2))
    got = ckpt.restore_checkpoint(str(tmp_path / "s"), template)
    want = moments_by_name(old)
    have = moments_by_name(got)
    assert set(have) == set(want)
    for n in want:
        assert torch.equal(have[n], want[n]), n
    # and the next step from the restored state is the old state's next step
    nxt_old, nxt_new = one_step(old), one_step(got)
    for a, b in zip(trainer.param_leaves(nxt_old["params"]),
                    trainer.param_leaves(nxt_new["params"])):
        assert torch.equal(a, b)


def test_same_shape_swap_is_bound_by_name(tmp_path):
    """wq and wo of a layer have one shape: a positional load would bind
    each one's moments to the other without an error."""

    def swapped(params):
        leaves = trainer.param_leaves(params)
        layer = params["layers"][0]
        i, j = (next(k for k, t in enumerate(leaves) if t is layer[n]) for n in ("wq", "wo"))
        assert leaves[i].shape == leaves[j].shape
        leaves[i], leaves[j] = leaves[j], leaves[i]
        return leaves

    old = one_step(lm_state(swapped))
    ckpt.save_checkpoint(str(tmp_path / "s"), old)
    template = lm_state(trainer.param_leaves)
    got = ckpt.restore_checkpoint(str(tmp_path / "s"), template)
    want, have = moments_by_name(old), moments_by_name(got)
    for n in ("layers.0.wq", "layers.0.wo"):
        assert torch.equal(have[n], want[n]), n
    assert not torch.equal(want["layers.0.wq"], want["layers.0.wo"])


def test_other_names_raise(tmp_path):
    old = one_step(lm_state(trainer.param_leaves))
    ckpt.save_checkpoint(str(tmp_path / "s"), old)
    other = dataclasses.replace(F32, n_layers=F32.n_layers + 1)
    params = tfm.init_params(other, torch.Generator().manual_seed(0))
    template = trainer.init_train_state(params, trainer.adamw(1e-2))
    with pytest.raises(ValueError):
        ckpt.restore_checkpoint(str(tmp_path / "s"), template)


def as_version_1(path):
    """Rewrite a checkpoint as version 1 wrote it: no names anywhere."""
    meta_file = os.path.join(path, ckpt.META_FILE)
    with open(meta_file) as f:
        meta = json.load(f)
    meta["version"] = 1
    meta.pop("opt_names", None)
    with open(meta_file, "w") as f:
        json.dump(meta, f)
    opt_file = os.path.join(path, ckpt.OPT_FILE)
    if os.path.exists(opt_file):
        opt = torch.load(opt_file, weights_only=True)
        opt.pop("param_names")
        torch.save(opt, opt_file)


def test_version_1_train_state_moments_are_refused(tmp_path):
    old = one_step(lm_state(pr9_param_leaves))
    path = str(tmp_path / "s")
    ckpt.save_checkpoint(path, old)
    as_version_1(path)
    template = lm_state(trainer.param_leaves)
    with pytest.raises(ValueError, match="version 1"):
        ckpt.restore_checkpoint(path, template)
    # its params still restore alone, and still serve
    got = ckpt.restore_checkpoint(path, {"params": template["params"]}, partial=True)
    for a, b in zip(trainer.param_leaves(got["params"]), trainer.param_leaves(old["params"])):
        assert torch.equal(a, b)
    params, _ = load_serving_params(path, F32, device="cpu")
    assert torch.equal(params["embed"], old["params"]["embed"].detach())


def test_version_1_bare_params_still_load(tmp_path):
    params = tfm.init_params(tfm.TINY, torch.Generator().manual_seed(3))
    path = str(tmp_path / "p")
    ckpt.save_checkpoint(path, params)
    as_version_1(path)
    assert ckpt.read_meta(path)["version"] == 1
    back = ckpt.restore_checkpoint(path)
    for a, b in zip(trainer.param_leaves(back), trainer.param_leaves(params)):
        assert torch.equal(a.view(torch.uint8), b.view(torch.uint8))
    served, step = load_serving_params(path, tfm.TINY, device="cpu")
    assert step is None and torch.equal(served["lm_head"], params["lm_head"])
    from devspace_tpu_torch import serve

    engine = serve.build_engine("tiny", device="cpu", checkpoint=path)
    assert torch.equal(engine.params["embed"], params["embed"])


def test_accumulate_gradients_over_a_module_matches_jax_grad():
    features = (64, 32, 10)
    jm = JMLP(features=features)
    x0 = np.zeros((1, 28, 28, 1), np.float32)
    variables = jax.tree.map(np.asarray, jax.jit(jm.init)(jax.random.PRNGKey(0), x0))
    tm = module_from_flax(MLP(features=features, device="cpu"), variables)
    rng = np.random.default_rng(0)
    images = rng.normal(size=(2, 4, 28, 28, 1)).astype(np.float32)
    labels = rng.integers(0, 10, size=(2, 4))

    def jloss(params, image, label):
        logits = jm.apply({"params": params}, image)
        lse = jax.nn.logsumexp(logits, axis=-1)
        return jnp.mean(lse - jnp.take_along_axis(logits, label[:, None], axis=-1)[:, 0])

    jgrads = [jax.grad(jloss)(variables["params"], images[i], labels[i]) for i in range(2)]
    want = jax.tree.map(lambda a, b: (np.asarray(a) + np.asarray(b)) / 2, *jgrads)

    def loss_fn(model, batch):
        image, label = batch
        return torch.nn.functional.cross_entropy(model(image), label)

    batches = [(torch.from_numpy(images[i]), torch.from_numpy(labels[i])) for i in range(2)]
    loss, grads = trainer.accumulate_gradients(loss_fn, 2)(tm, batches)
    assert list(grads) == [n for n, _ in tm.named_parameters()]
    for name, g in grads.items():
        layer, leaf = name.split(".")
        w = want[layer][leaf]
        np.testing.assert_allclose(g.numpy(), w, rtol=1e-6, atol=1e-6 * np.abs(w).max())
    assert torch.isfinite(loss)
