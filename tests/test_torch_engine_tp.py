"""Tensor-parallel serving: the port's ``InferenceEngine(mesh=)`` at
``model = 2`` over a gloo world of 2 ranks against the one-process
engine and the JAX package's ``InferenceEngine(mesh=)`` on its CPU mesh.

TINY in float32 (the dryrun's ``engine_tp`` config: greedy equality
across reduction orders needs float32), prompts ``[5, 1, 4]`` and
``[2, 2, 2, 2, 2]``. Greedy streams must be EQUAL, token for token:
rank 0's, the streams every other rank mirrored, the one-process
engine's and the JAX engine's. Each engine is prewarmed, and its
``graph_captures`` must not move afterwards.
"""

import jax
import jax.numpy as jnp
import pytest
import torch

from devspace_tpu.inference import InferenceEngine as JEngine
from devspace_tpu.inference.quantization import quantize_params as jquantize
from devspace_tpu.models import transformer as jtfm
from devspace_tpu.parallel.mesh import create_mesh as jcreate_mesh
from devspace_tpu_torch.inference import InferenceEngine
from devspace_tpu_torch.inference.quantization import quantize_params
from devspace_tpu_torch.models import transformer as ttfm
from devspace_tpu_torch.models.convert import params_from_numpy
import torch_parallel_workers as w
from test_torch_parallel_tp import TINY32, np_tree
from torch_parallel_world import World

PROMPTS = [[5, 1, 4], [2, 2, 2, 2, 2]]
N_NEW = 6
RUN_TIMEOUT = 180.0  # a rank that falls out of step fails the test instead of hanging it


@pytest.fixture(scope="module")
def world(tmp_path_factory):
    wd = World(2, tmp_path_factory.mktemp("gloo"))
    yield wd
    wd.close()


@pytest.fixture(scope="module")
def params_np():
    cfg = jtfm.TransformerConfig(**TINY32, dtype=jnp.float32)
    return np_tree(jtfm.init_params(cfg, jax.random.PRNGKey(7)))


def one_process(params_np, quantize=False, kv_dtype=None, **kw):
    cfg = ttfm.TransformerConfig(**TINY32, dtype=torch.float32)
    params = params_from_numpy(params_np, "cpu")
    engine = InferenceEngine(quantize_params(params) if quantize else params, cfg, max_slots=2,
                             max_len=32, device="cpu", kv_dtype=kv_dtype, **kw).start()
    try:
        return [engine.submit(p, N_NEW).result(timeout=60) for p in PROMPTS]
    finally:
        engine.stop()


def jax_tp(params_np, quantize=False, kv_dtype=None):
    cfg = jtfm.TransformerConfig(**TINY32, dtype=jnp.float32)
    params = jax.tree.map(jnp.asarray, params_np)
    mesh = jcreate_mesh({"model": 2}, devices=jax.devices()[:2])
    engine = JEngine(jquantize(params) if quantize else params, cfg, max_slots=2, max_len=32,
                     mesh=mesh, kv_dtype=kv_dtype).start()
    try:
        return [engine.submit(p, N_NEW).result(timeout=300) for p in PROMPTS]
    finally:
        engine.stop()


def assert_ranks_serve(got, want):
    for rank, r in enumerate(got):
        assert r["streams"] == want, rank
        assert r["dispatch"] == {"impl": "reference", "tp": True}
        assert r["captures"][0] == r["captures"][1] > 0
        assert r["pool_heads"] == 1  # TINY's 2 KV heads, one a rank
    assert got[0]["refused"] is None
    assert "rank 0 of the model axis" in got[1]["refused"]


@pytest.mark.parametrize("kv_dtype", [None, "int8"])
def test_tp_streams_equal_one_process_and_the_jax_engine(world, params_np, kv_dtype):
    ref = one_process(params_np, kv_dtype=kv_dtype)
    assert jax_tp(params_np, kv_dtype=kv_dtype) == ref
    got = world.run(w.engine_tp_streams, {"model": 2}, params_np, TINY32, PROMPTS, N_NEW,
                    kv_dtype, timeout=RUN_TIMEOUT)
    assert_ranks_serve(got, ref)


def test_tp_int8_weights_equal_one_process_and_the_jax_engine(world, params_np):
    """``tests/test_inference.py``'s int8-under-a-mesh case: the int8
    matrices shard like the dense ones, each scale on the out dim."""
    ref = one_process(params_np, quantize=True)
    assert jax_tp(params_np, quantize=True) == ref
    got = world.run(w.engine_tp_streams, {"model": 2}, params_np, TINY32, PROMPTS, N_NEW,
                    None, True, timeout=RUN_TIMEOUT)
    assert_ranks_serve(got, ref)


def test_speculative_tp_equals_plain_decoding(world, params_np):
    """``tests/test_inference.py``'s speculative TP case: the draft (the
    target itself) sharded like the target, its dense cache over KV
    heads, spec rounds run; greedy streams are plain decoding's."""
    ref = one_process(params_np)
    got = world.run(w.engine_tp_streams, {"model": 2}, params_np, TINY32, PROMPTS, N_NEW,
                    None, False, params_np, TINY32, False, None, 3, timeout=RUN_TIMEOUT)
    assert_ranks_serve(got, ref)
    assert all(r["spec_rounds"] > 0 for r in got)


def test_a_request_submitted_mid_stream_is_served(world, params_np):
    """Rank 0 submits the second prompt after the first has streamed a
    token: the next plan carries it to the other rank, nothing hangs."""
    ref = one_process(params_np)
    got = world.run(w.engine_tp_streams, {"model": 2}, params_np, TINY32, PROMPTS, N_NEW,
                    None, False, None, None, True, timeout=RUN_TIMEOUT)
    assert_ranks_serve(got, ref)


@pytest.mark.parametrize("which", ["target", "draft"])
def test_indivisible_kv_heads_raise(world, which):
    """``n_kv_heads`` (the draft's too) must divide by the model axis
    (``tests/test_inference.py``'s indivisible case)."""
    odd = {**TINY32, "n_heads": 3, "n_kv_heads": 3, "dim": 48}
    args = (odd,) if which == "target" else (TINY32, odd)
    for msg in world.run(w.engine_tp_indivisible, *args, timeout=RUN_TIMEOUT):
        want = "n_kv_heads 3 not divisible by mesh axis 'model' (2)"
        assert msg == (want if which == "target" else "draft " + want)


def test_paged_attention_records_tp(monkeypatch):
    from devspace_tpu_torch.ops import paged_attention as tpa

    monkeypatch.setattr(tpa, "LAST_DISPATCH", dict(tpa.LAST_DISPATCH))
    q = torch.zeros(1, 2, 8)
    pool = torch.zeros(2, 1, 4, 8)
    tables = torch.ones(1, 1, dtype=torch.int32)
    lengths = torch.ones(1, dtype=torch.int32)
    tpa.paged_decode_attention(q, pool, pool, tables, lengths, tp=("mesh", "model"))
    assert tpa.LAST_DISPATCH == {"impl": "reference", "tp": True}
    tpa.paged_decode_attention(q, pool, pool, tables, lengths)
    assert tpa.LAST_DISPATCH == {"impl": "reference", "tp": False}
