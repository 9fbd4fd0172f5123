"""The checkpoint seam's mesh parts over a gloo world of 2 ranks:
``sharded_template`` restores each rank's block of the logical arrays, a
train state sharded over ``pipe`` or over FSDP's ``data`` saves from the
mesh (gathered, written by rank 0) and restores in one process equal to
the logical state, and ``load_serving_params(mesh=)`` /
``InferenceEngine.from_checkpoint(mesh=)`` serve what the in-memory
params serve.

TINY in float32, params from the JAX package's init through numpy.
Blocks, restored params and moments are compared EXACTLY (a restore
copies bytes); greedy streams token for token.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from devspace_tpu.models import transformer as jtfm
from devspace_tpu_torch.inference.quantization import quantize_params
from devspace_tpu_torch.models import transformer as ttfm
from devspace_tpu_torch.models.convert import params_from_numpy, params_to_numpy
from devspace_tpu_torch.parallel import pipeline as tpipe
from devspace_tpu_torch.training import checkpoint as tckpt
from devspace_tpu_torch.training import trainer as ttrainer
import torch_parallel_workers as w
from test_torch_engine_tp import N_NEW, PROMPTS, one_process
from test_torch_parallel_tp import TINY32, np_tree
from torch_parallel_world import World

RUN_TIMEOUT = 180.0


@pytest.fixture(scope="module")
def world(tmp_path_factory):
    wd = World(2, tmp_path_factory.mktemp("gloo"))
    yield wd
    wd.close()


@pytest.fixture(scope="module")
def params_np():
    cfg = jtfm.TransformerConfig(**TINY32, dtype=jnp.float32)
    return np_tree(jtfm.init_params(cfg, jax.random.PRNGKey(11)))


@pytest.fixture(scope="module")
def saved(params_np, tmp_path_factory):
    path = str(tmp_path_factory.mktemp("ckpt") / "step_00000003")
    tckpt.save_checkpoint(path, params_from_numpy(params_np, "cpu"))
    return path


def block(x: np.ndarray, spec, index: int, n: int = 2) -> np.ndarray:
    for dim, axis in enumerate(spec):
        if axis is not None:
            x = np.split(x, n, axis=dim)[index]
    return x


def expected_blocks(tree, index):
    cfg = ttfm.TransformerConfig(**TINY32, dtype=torch.float32)
    spec = ttfm.param_partition_spec(cfg, "model")
    return jax.tree.map(lambda x, s: block(x, s, index), tree, spec,
                        is_leaf=lambda x: isinstance(x, tuple) and not isinstance(x, np.ndarray))


def test_sharded_template_restores_each_ranks_block(world, params_np, saved):
    got = world.run(w.sharded_restore_case, saved, {"model": 2}, TINY32, timeout=RUN_TIMEOUT)
    assert sorted(r["index"] for r in got) == [0, 1]
    for r in got:
        want = expected_blocks(params_np, r["index"])
        jax.tree.map(np.testing.assert_array_equal, want, r["blocks"])
        jax.tree.map(np.testing.assert_array_equal, want, r["serving"])


def test_int8_serving_params_on_a_mesh_are_the_whole_weights_cut(world, params_np, saved):
    """Quantized whole, then cut: each ``q`` is the block of the whole
    weight's, each scale the block of its scales along the out dim (whole
    where the out dim is not sharded)."""
    whole = params_to_numpy(quantize_params(params_from_numpy(params_np, "cpu")))
    cfg = ttfm.TransformerConfig(**TINY32, dtype=torch.float32)
    spec = ttfm.param_partition_spec(cfg, "model")
    got = world.run(w.sharded_restore_case, saved, {"model": 2}, TINY32, True,
                    timeout=RUN_TIMEOUT)
    for r in got:
        i = r["index"]
        leaves = [("lm_head", whole["lm_head"], r["serving"]["lm_head"], spec["lm_head"])]
        for li, layer in enumerate(whole["layers"]):
            for name in ("wq", "wk", "wv", "wo", "w_gate", "w_up", "w_down"):
                leaves.append((f"{li}.{name}", layer[name], r["serving"]["layers"][li][name],
                               spec["layers"][li][name]))
        for name, (q, scale), (gq, gscale), s in leaves:
            np.testing.assert_array_equal(gq, block(q, s, i), err_msg=name)
            np.testing.assert_array_equal(gscale, block(scale, (s[1],), i), err_msg=name)
        np.testing.assert_array_equal(r["serving"]["embed"], whole["embed"])


@pytest.mark.parametrize("kind", ["pipe", "fsdp"])
def test_a_state_saved_from_a_mesh_restores_in_one_process(world, params_np, tmp_path, kind):
    tokens = np.random.default_rng(0).integers(0, 256, (2, 2, 17))
    if kind == "fsdp":
        tokens = tokens.reshape(4, 17)
    got = world.run(w.mesh_save_case, str(tmp_path), kind, params_np, TINY32, tokens, 1e-2,
                    timeout=RUN_TIMEOUT)
    for r in got:  # every rank returned after the save: the step is complete
        assert r["complete"] == ["meta.json", "opt_state.pt", "params.pt"]
    logical, moments = got[0]["params"], got[0]["moments"]
    jax.tree.map(np.testing.assert_array_equal, logical, got[1]["params"])
    path = str(tmp_path / "step_00000001")
    meta = tckpt.read_meta(path)
    assert meta["version"] == tckpt.VERSION and meta["kind"] == "train_state"
    # restored as saved, without a template
    raw = tckpt.restore_checkpoint(path)
    jax.tree.map(np.testing.assert_array_equal, logical, params_to_numpy(raw["params"]))
    names = raw["opt_state"]["param_names"]
    for i, entry in raw["opt_state"]["state"].items():
        for k, v in entry.items():
            np.testing.assert_array_equal(v.numpy(), moments[names[i]][k], err_msg=names[i])
    # and into a one-process train state: params filled, moments bound by name
    params = params_from_numpy(params_np, "cpu")
    if kind == "pipe":
        params = tpipe.transformer_stage_params(params, 2)
    state = ttrainer.init_train_state(params, ttrainer.adamw(1e-2))
    state["opt_state"].zero_grad()
    for p in ttrainer.param_leaves(state["params"]):
        p.grad = torch.zeros_like(p)
    state["opt_state"].step()  # creates the moments the restore fills
    out = tckpt.restore_checkpoint(path, state)
    jax.tree.map(np.testing.assert_array_equal, logical, params_to_numpy(out["params"]))
    by_name = dict(zip(tckpt.param_names(out["params"], out["opt_state"]),
                       ttrainer.param_leaves(out["params"])))
    for name, p in by_name.items():
        for k in ("exp_avg", "exp_avg_sq"):
            np.testing.assert_array_equal(out["opt_state"].state[p][k].numpy(),
                                          moments[name][k], err_msg=name)
    assert out["step"] == 1


def test_from_checkpoint_on_a_mesh_serves_the_in_memory_streams(world, params_np, saved):
    ref = one_process(params_np)
    got = world.run(w.engine_tp_streams, {"model": 2}, None, TINY32, PROMPTS, N_NEW, None,
                    False, None, None, False, saved, timeout=RUN_TIMEOUT)
    for r in got:
        assert r["streams"] == ref
        assert r["dispatch"] == {"impl": "reference", "tp": True}
        assert r["pool_heads"] == 1
