"""The port's meshes, partition specs and data parallelism over a gloo
world of 4 ranks, against the JAX package where it has a counterpart.

float32, inputs from numpy seeds. Tolerances: losses and params after a
step ``rtol=1e-5, atol=1e-6`` (the same arithmetic over another split
of the rows); a classifier step's update within ``1e-4`` of the
single-device update's largest change per leaf, or one float32 ulp of
the leaf (``test_torch_parallel_tp.assert_updates_close``).
"""

import subprocess
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from devspace_tpu.parallel.mesh import mesh_shape_for as jmesh_shape_for
from devspace_tpu.training.data import host_shard as jhost_shard
from devspace_tpu_torch.parallel import mesh as tmesh
from devspace_tpu_torch.training import data as tdata
from devspace_tpu_torch.training import trainer as ttrainer
import torch_parallel_workers as w
from test_torch_parallel_tp import assert_updates_close
from torch_parallel_world import World

TOL = dict(rtol=1e-5, atol=1e-6)
REPO = Path(__file__).resolve().parent.parent


@pytest.fixture(scope="module")
def world(tmp_path_factory):
    wd = World(4, tmp_path_factory.mktemp("gloo"))
    yield wd
    wd.close()


@pytest.mark.parametrize("n,axes", [
    (8, {"data": -1}), (8, {"data": -1, "model": 2}), (8, {"data": 2, "model": 2, "seq": 2}),
    (8, {"data": 3, "model": 2}), (8, {"data": -1, "model": -1}), (8, {"data": 0}),
    (6, {"data": -1, "model": 4}), (4, {"data": True}),
])
def test_mesh_shape_for_is_the_references(n, axes):
    try:
        ref = jmesh_shape_for(n, axes)
    except ValueError as e:
        with pytest.raises(ValueError) as got:
            tmesh.mesh_shape_for(n, axes)
        assert str(got.value) == str(e)
    else:
        assert tmesh.mesh_shape_for(n, axes) == ref


def test_create_mesh_lays_ranks_out_row_major(world):
    for r in world.run(w.mesh_layout, {"data": 2, "model": 2}):
        rank = r["rank"]
        assert r["shape"] == {"data": 2, "model": 2}
        assert r["index"] == {"data": rank // 2, "model": rank % 2}
        assert r["group_ranks"]["model"] == [2 * (rank // 2), 2 * (rank // 2) + 1]
        assert r["group_ranks"]["data"] == [rank % 2, rank % 2 + 2]
    for r in world.run(w.mesh_layout, {"data": -1}):
        assert r["shape"] == {"data": 4} and r["index"] == {"data": r["rank"]}


def test_a_mesh_on_the_card_needs_nccl(world):
    for msg in world.run(w.mesh_backend_mismatch):
        assert "needs the nccl backend" in msg and "gloo" in msg


def test_one_process_forms_a_world_of_one_and_tears_it_down():
    code = ("from devspace_tpu_torch.parallel.mesh import create_mesh, distributed\n"
            "import torch.distributed as dist\n"
            "try:\n"
            "    create_mesh(device='cpu')\n"
            "except RuntimeError as e:\n"
            "    print('no group:', 'distributed()' in str(e))\n"
            "with distributed('cpu'):\n"
            "    m = create_mesh({'data': -1, 'model': 1}, device='cpu')\n"
            "    print(m.shape, dist.get_backend(), m.index('data'), m.size('model'))\n"
            "print('after:', dist.is_initialized())\n")
    out = subprocess.run([sys.executable, "-c", code], cwd=REPO, capture_output=True,
                         text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert out.stdout.splitlines() == ["no group: True", "{'data': 1, 'model': 1} gloo 0 1",
                                       "after: False"]


def test_multihost_initialize_env_wiring(monkeypatch):
    """The charts' JAX_COORDINATOR_ADDRESS / TPU_WORKER_ID /
    JAX_NUM_PROCESSES, or torchrun's RANK / WORLD_SIZE, become the
    process group's bootstrap; one process is a no-op."""
    for name in ("JAX_COORDINATOR_ADDRESS", "JAX_NUM_PROCESSES", "TPU_WORKER_ID", "WORLD_SIZE",
                 "RANK"):
        monkeypatch.delenv(name, raising=False)
    calls = []
    monkeypatch.setattr(tmesh.dist, "init_process_group",
                        lambda backend, **kw: calls.append((backend, kw)))
    assert tmesh.multihost_initialize(device="cpu") is False
    monkeypatch.setenv("JAX_COORDINATOR_ADDRESS", "host-0:8476")
    monkeypatch.setenv("JAX_NUM_PROCESSES", "4")
    monkeypatch.setenv("TPU_WORKER_ID", "2")
    assert tmesh.multihost_initialize(device="cpu") is True
    assert calls == [("gloo", {"init_method": "tcp://host-0:8476", "world_size": 4, "rank": 2})]
    calls.clear()
    monkeypatch.setenv("JAX_NUM_PROCESSES", "1")
    assert tmesh.multihost_initialize(device="cpu") is False and calls == []
    monkeypatch.setenv("WORLD_SIZE", "2")
    monkeypatch.setenv("RANK", "1")
    assert tmesh.multihost_initialize(device="cpu") is True
    assert calls == [("gloo", {"init_method": "env://", "world_size": 2, "rank": 1})]


def test_shard_and_gather_round_trip(world):
    x = np.arange(4 * 6 * 2, dtype=np.float32).reshape(4, 6, 2)
    for spec in (("data", "model"), (None, "model"), ("model",), ()):
        for r in world.run(w.shard_and_gather, {"data": 2, "model": 2}, spec, x):
            np.testing.assert_array_equal(r["full"], x)
            expect = x
            for dim, axis in enumerate(spec):
                if axis is not None:
                    expect = np.split(expect, 2, axis=dim)[r["index"][axis]]
            np.testing.assert_array_equal(r["block"], expect)


def test_shard_tensor_rejects_an_indivisible_dim():
    class OneAxis:
        def size(self, axis):
            return 4

        def index(self, axis):
            return 0

    with pytest.raises(ValueError, match="not divisible"):
        tmesh.shard_tensor(torch.zeros(6, 4), tmesh.P("data"), OneAxis())
    with pytest.raises(TypeError):
        tmesh.P(("data", "model"))


def test_data_parallel_step_matches_single_device(world):
    rng = np.random.default_rng(0)
    w0 = rng.standard_normal((16, 4)).astype(np.float32)
    xs = rng.standard_normal((32, 16)).astype(np.float32)
    ys = rng.standard_normal((32, 4)).astype(np.float32)

    def loss_fn(p, b):
        return jnp.mean((b["x"] @ p["w"] - b["y"]) ** 2)

    params, batch = {"w": jnp.asarray(w0)}, {"x": jnp.asarray(xs), "y": jnp.asarray(ys)}
    grads = jax.grad(loss_fn)(params, batch)
    ref_w = np.asarray(params["w"] - 0.1 * grads["w"])
    ref_loss = float(loss_fn(params, batch))
    for r in world.run(w.dp_step, w0, xs, ys, 0.1):
        assert r["rows"] == 8
        np.testing.assert_allclose(r["w"], ref_w, **TOL)
        np.testing.assert_allclose(r["loss"], ref_loss, **TOL)
    # the explicit psum form: the averaged loss's gradient, summed over
    # the axis, is the global mean's
    for r in world.run(w.dp_psum_mean_grad, w0, xs, ys):
        np.testing.assert_allclose(r[0], np.asarray(grads["w"]), **TOL)
        np.testing.assert_allclose(r[1], ref_loss, **TOL)
    for r in world.run(w.dp_eval, w0, xs):
        np.testing.assert_allclose(r, xs @ w0, **TOL)


def test_prefetch_to_device_keeps_this_ranks_rows_in_order(world):
    for rank, got in enumerate(world.run(w.prefetch_sharded, 5)):
        assert len(got) == 5
        for i, x in enumerate(got):
            np.testing.assert_array_equal(x[:, 0], i + np.arange(2 * rank, 2 * rank + 2))


def test_host_shard_is_the_references():
    batch = {"x": np.arange(8), "y": np.arange(16).reshape(8, 2)}
    for pi in range(4):
        got = tdata.host_shard(batch, process_index=pi, process_count=4)
        ref = jhost_shard(batch, process_index=pi, process_count=4)
        for k in batch:
            np.testing.assert_array_equal(np.asarray(got[k]), np.asarray(ref[k]))
    with pytest.raises(ValueError):
        tdata.host_shard({"x": np.arange(6)}, process_index=0, process_count=4)


@pytest.mark.parametrize("model_name", ["mlp", "resnet"])
def test_classifier_step_over_a_data_mesh_matches_one_device(world, model_name):
    """One SGD(0.1, momentum 0.9) step over ``{"data": 4}`` against the
    port's single-device step on the whole batch (itself held to the JAX
    package in test_torch_mlp_data.py and test_torch_resnet.py). The
    ResNet's BatchNorm takes the global batch's statistics: the loss,
    every update and the running statistics equal one device's."""
    from devspace_tpu_torch.models.mlp import MLP
    from devspace_tpu_torch.models.resnet import ResNet

    rng = np.random.default_rng(1)
    if model_name == "mlp":
        model = MLP(features=(32, 10), device="cpu")
        images = rng.standard_normal((16, 28, 28, 1)).astype(np.float32)
    else:
        model = ResNet(stage_sizes=(1, 1), num_classes=10, num_filters=8, dtype=torch.float32,
                       device="cpu")
        images = rng.standard_normal((16, 32, 32, 3)).astype(np.float32)
    labels = rng.integers(0, 10, size=16)
    before = {k: v.detach().numpy().copy() for k, v in model.state_dict().items()}
    opt = ttrainer.sgd(0.1, momentum=0.9)
    state = ttrainer.init_train_state(model, opt)
    step = ttrainer.make_classifier_train_step(model, opt, has_batch_stats=model_name != "mlp")
    # one thread, as each rank has: the threaded CPU step's gradients vary
    # from run to run in their last bits, which updates at 1e-4 can resolve
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        state, loss = step(state, {"image": torch.from_numpy(images),
                                   "label": torch.from_numpy(labels)})
    finally:
        torch.set_num_threads(threads)
    ref = {k: v.detach().numpy() for k, v in model.state_dict().items()}
    for r in world.run(w.classifier_mesh_step, model_name, before, images, labels, 0.1):
        np.testing.assert_allclose(r["loss"], float(loss), rtol=1e-5)
        stats = [k for k in ref if k.endswith((".mean", ".var"))]
        assert (model_name == "resnet") == bool(stats)
        for k in stats:
            np.testing.assert_allclose(r["state"][k], ref[k], **TOL, err_msg=k)
        params = [k for k in ref if k not in stats]
        assert_updates_close({k: before[k] for k in params}, {k: ref[k] for k in params},
                             {k: r["state"][k] for k in params})
