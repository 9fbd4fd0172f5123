"""The port's sharding preflight (devspace_tpu_torch/lint/rules_sharding.py)
against the JAX package's, on the meshes, specs and shapes of
tests/test_lint_sharding.py, each package with its own ``PartitionSpec``
(a multi-axis dim, which the port's spec does not hold, as a plain
tuple): SHD300-303 give equal (rule_id, location). SHD304's cases (the
step, the cast, the out-of-range argnum) are written once in jax and
once in torch, the port's run on meta tensors. And the meta device
through the kernel wrappers: every plain version traces shapes, no
wrapper reaches a kernel build, and a mix of devices still raises."""

import types

import jax
import jax.numpy as jnp
import pytest
import torch
from jax.sharding import PartitionSpec as JP

from devspace_tpu.config import latest
from devspace_tpu.lint import donation_preflight as jdonation
from devspace_tpu.lint import mesh_axes_for_tpu as jaxes
from devspace_tpu.lint import sharding_preflight as jpreflight
from devspace_tpu_torch.lint import donation_preflight as tdonation
from devspace_tpu_torch.lint import mesh_axes_for_tpu as taxes
from devspace_tpu_torch.lint import sharding_preflight as tpreflight
from devspace_tpu_torch.lint import tree_shardings
from devspace_tpu_torch.models import transformer as tfm
from devspace_tpu_torch.ops import _build, dispatch
from devspace_tpu_torch.parallel.mesh import P as TP

TPU_4x4 = latest.TPUConfig(accelerator="v5litepod-16", topology="4x4", workers=4,
                           chips_per_worker=4)

# (mesh axes, {name: (shape, spec entries)}, preflight kwargs): the
# reference's cases
CASES = {
    "nonexistent_axis": ({"data": 4, "model": 2}, {"w": ((8, 8), (None, "tensor"))}, {}),
    "non_divisible": ({"data": 4, "model": 2}, {"acts": ((16, 7), ("data", "model"))}, {}),
    "divisible": ({"data": 4, "model": 2}, {"acts": ((16, 8), ("data", "model")),
                                           "fsdp": ((32,), (("data", "model"),))}, {}),
    "multi_axis_product": ({"data": 4, "model": 2}, {"fsdp": ((12,), (("data", "model"),))}, {}),
    "duplicate_axis": ({"data": 4, "model": 2}, {"dup": ((8, 8), ("data", "data"))}, {}),
    "rank_exceeds": ({"data": 4}, {"v": ((8,), ("data", None))}, {}),
    "unbuildable": ({"data": 3, "model": 2}, {}, {"n_devices": 8}),
    "unresolved_wildcard": ({"data": -1}, {}, {}),
    "tpu_config": ({"data": -1, "model": 2}, {"embed": ((48, 512), ("data", "model")),
                                             "bad_axis": ((16, 16), ("expert", None)),
                                             "bad_dim": ((10, 16), ("data", None))},
                   {"tpu": TPU_4x4}),
}


def spec(cls, entries):
    if any(isinstance(e, tuple) for e in entries) and cls is TP:
        return tuple(entries)  # the port's P names one axis a dim
    return cls(*entries)


def findings_of(preflight, cls, name):
    axes, shardings, kw = CASES[name]
    got = preflight(axes, {k: (shape, spec(cls, e)) for k, (shape, e) in shardings.items()},
                    **kw)
    return sorted((f.rule_id, f.location) for f in got), got


@pytest.mark.parametrize("name", sorted(CASES))
def test_shd300_303_equal_the_reference(name):
    got, raw = findings_of(tpreflight, TP, name)
    assert got == findings_of(jpreflight, JP, name)[0]
    want = {"nonexistent_axis": [("SHD301", "w")], "non_divisible": [("SHD302", "acts")],
            "divisible": [], "multi_axis_product": [("SHD302", "fsdp")],
            "duplicate_axis": [("SHD303", "dup")], "rank_exceeds": [("SHD302", "v")],
            "unbuildable": [("SHD300", "mesh")], "unresolved_wildcard": [("SHD300", "mesh")],
            "tpu_config": [("SHD301", "bad_axis"), ("SHD302", "bad_dim")]}[name]
    assert got == want
    if name == "multi_axis_product":
        assert "dataxmodel = 8" in raw[0].message


def test_shapes_from_tensors_and_unshapeable_values():
    assert tpreflight({"data": 2}, {"x": (torch.zeros(4, 4), TP("data", None))}) == []
    assert tpreflight({"data": 2}, {"x": (torch.empty(4, 4, device="meta"), TP("data"))}) == []
    got = tpreflight({"data": 2}, {"x": (object(), TP("data"))})
    assert [f.rule_id for f in got] == ["SHD302"] and "unshapeable" in got[0].message


def test_mesh_axes_for_a_deployment_block_equal_the_reference():
    for tpu, axes in ((TPU_4x4, {"data": -1, "model": 2}),
                      (latest.TPUConfig(workers=2, chips_per_worker=4), {"data": -1}),
                      (types.SimpleNamespace(topology="", workers=2, chips_per_worker=8),
                       {"data": 2, "model": -1})):
        assert taxes(tpu, axes) == jaxes(tpu, axes)
    with pytest.raises(ValueError, match="positive integer"):
        taxes(types.SimpleNamespace(topology="0x4", workers=1, chips_per_worker=1), {"d": -1})


def test_tree_shardings_reads_a_spec_tree_as_map_with_spec():
    params = tfm.init_params(tfm.TINY, torch.Generator(), device="meta")
    flat = tree_shardings(params, tfm.param_partition_spec(tfm.TINY))
    assert len(flat) == 3 + 9 * tfm.TINY.n_layers
    shape, s = flat["layers.1.wq"]
    assert tuple(shape.shape) == (64, 64) and s == TP(None, "model")
    assert flat["embed"][1] == TP()
    # a spec at a subtree covers it; None is replicated
    got = tree_shardings({"a": [torch.zeros(2), torch.zeros(4)], "b": torch.zeros(3)},
                         {"a": TP("x"), "b": None})
    assert {k: v[1] for k, v in got.items()} == {"a.0": TP("x"), "a.1": TP("x"), "b": TP()}
    assert [f.rule_id for f in tpreflight({"model": 3}, flat)] == ["SHD302"] * 15


# -- SHD304: the reference's cases, once in jax and once in torch --------------
def jax_step(params, batch):
    return jax.tree_util.tree_map(lambda p: p * 2.0, params), jnp.sum(batch)


def torch_step(params, batch):
    return {k: v * 2.0 for k, v in params.items()}, batch.sum()


def donation_cases():
    jparams = {"w": jax.ShapeDtypeStruct((128, 128), jnp.float32),
               "b": jax.ShapeDtypeStruct((128,), jnp.float32)}
    jbatch = jax.ShapeDtypeStruct((32, 128), jnp.float32)
    tparams = {"w": torch.empty(128, 128, device="meta"), "b": torch.empty(128)}
    tbatch = torch.empty(32, 128, device="meta")
    return {
        "step_params": ((jax_step, (jparams, jbatch), (0,)),
                        (torch_step, (tparams, tbatch), (0,))),
        "step_batch_too": ((jax_step, (jparams, jbatch), (0, 1)),
                           (torch_step, (tparams, tbatch), (0, 1))),
        "cast": ((lambda x: x.astype(jnp.bfloat16), (jax.ShapeDtypeStruct((64,), jnp.float32),),
                  (0,)),
                 (lambda x: x.to(torch.bfloat16), (torch.empty(64),), (0,))),
        "out_of_range": ((lambda x: x, (jax.ShapeDtypeStruct((4,), jnp.float32),), (3,)),
                         (lambda x: x, (torch.empty(4),), (3,))),
    }


@pytest.mark.parametrize("name", ["step_params", "step_batch_too", "cast", "out_of_range"])
def test_shd304_equals_the_reference(name):
    (jfn, jargs, jdonate), (tfn, targs, tdonate) = donation_cases()[name]
    want = jdonation(jfn, jargs, donate_argnums=jdonate)
    got = tdonation(tfn, targs, donate_argnums=tdonate)
    assert [(f.rule_id, f.severity, f.location) for f in got] == [
        (f.rule_id, f.severity, f.location) for f in want]
    if name == "step_batch_too":
        assert "(32, 128)" in got[0].message
    if name == "out_of_range":
        assert "only 1 positional" in got[0].message
    if name == "step_params":
        assert got == []


def test_shd304_runs_on_meta_and_keeps_meta_leaves():
    """Nothing is computed: a CPU argument reaches ``fn`` as a meta tensor,
    and a meta argument as itself (its requires_grad kept)."""
    seen = []
    w = torch.empty(8, 8, device="meta").requires_grad_()

    def fn(w, x):
        seen.extend([w, x])
        return w * 2, x

    assert tdonation(fn, (w, torch.ones(1000, 1000)), donate_argnums=(0, 1)) == []
    assert seen[0] is w and seen[1].device.type == "meta" and seen[0].requires_grad


def test_trainer_update_and_decode_step_on_meta_are_clean():
    """The two functions chip_smoke's analysis phase checks, at TINY: the
    trainer's AdamW update (params in, params out) and a paged decode
    step writing the pool in place."""
    from devspace_tpu_torch.parallel import mesh as pmesh
    from devspace_tpu_torch.training import trainer

    params = pmesh.tree_map(lambda t: t.requires_grad_(),
                            tfm.init_params(tfm.TINY, torch.Generator(), device="meta"))

    def update(params, tokens):
        state = trainer.init_train_state(params, trainer.adamw(3e-4))
        state, _ = trainer.make_lm_train_step(tfm.forward, tfm.TINY, None)(state, tokens)
        return state["params"]

    tokens = torch.empty(2, 17, dtype=torch.long, device="meta")
    assert tdonation(update, (params, tokens), donate_argnums=(0,)) == []
    assert [f.rule_id for f in tdonation(update, (params, tokens), donate_argnums=(0, 1))] == [
        "SHD304"]
    pool = tfm.init_paged_pool(tfm.TINY, 9, 16, kv_dtype="int8", device="meta")

    def step(params, pool, tables, tok, pos):
        with torch.no_grad():
            return tfm.decode_tokens_paged(params, pool, tables, tok, pos, tfm.TINY)

    args = (tfm.init_params(tfm.TINY, torch.Generator(), device="meta"), pool,
            torch.empty(2, 4, dtype=torch.int32), torch.empty(2, dtype=torch.long),
            torch.empty(2, dtype=torch.long))
    assert tdonation(step, args, donate_argnums=(1,)) == []


# -- the meta device through the kernel wrappers --------------------------------
def test_on_cuda_meta_repair():
    meta, cpu = torch.empty(2, device="meta"), torch.empty(2)
    cuda = types.SimpleNamespace(device=torch.device("cuda", 0))  # no card here
    assert dispatch.on_cuda(meta, meta) is False
    assert dispatch.on_cuda(cpu) is False and dispatch.on_cuda(cuda) is True
    for mix in ((cpu, meta), (meta, cuda), (cpu, cuda)):
        with pytest.raises(ValueError, match="CUDA device or all on the CPU"):
            dispatch.on_cuda(*mix)


def test_no_wrapper_builds_a_kernel_for_meta_tensors(monkeypatch):
    from devspace_tpu_torch.ops import attention, flash_attention, losses, normalization
    from devspace_tpu_torch.ops import paged_attention

    def no_build(*a, **k):
        raise AssertionError("a kernel build was reached for meta tensors")

    monkeypatch.setattr(_build, "library", no_build)
    m = dict(device="meta")
    q4 = torch.empty(1, 4, 128, 64, dtype=torch.bfloat16, **m)
    assert attention.fused_attention(q4, q4, q4).shape == q4.shape
    q = torch.empty(4, 128, 64, dtype=torch.bfloat16, **m)
    o, lse = flash_attention.flash_fwd(q, q, q, causal=True)
    assert o.shape == q.shape and lse.shape == (4, 128)
    logits = torch.empty(8, 32, **m)
    labels = torch.empty(8, dtype=torch.long, **m)
    assert losses.fused_cross_entropy(logits, labels).shape == (8,)
    x = torch.empty(8, 64, dtype=torch.bfloat16, **m)
    assert normalization.fused_rms_norm(x, torch.empty(64, **m)).shape == x.shape
    pool = torch.empty(9, 2, 16, 64, dtype=torch.bfloat16, **m)
    out = paged_attention.paged_decode_attention(
        torch.empty(2, 4, 64, dtype=torch.bfloat16, **m), pool, pool,
        torch.empty(2, 4, dtype=torch.int32, **m), torch.empty(2, dtype=torch.int32, **m))
    assert out.shape == (2, 4, 64)
