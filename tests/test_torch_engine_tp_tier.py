"""The host KV tier under tensor-parallel serving: the port's
``InferenceEngine(mesh=, kv_tier=)`` at ``model = 2`` over a gloo world
of 2 ranks, against the one-process port engine and the JAX package's
engine.

float32 TINY with the JAX package's weights, an int8 pool (its resident
blocks are the spill format, so a restore is exact), the spill-and-
restore waves of ``test_torch_kv_tier_engine.py`` (a shared prompt
flooded out of the pool, then hit again). Rank 0 of the axis holds the
tier; the other rank follows its decisions. Compared EXACTLY: the
streams (rank 0's and the ones rank 1 mirrored), the tier and migration
counters, and the KVM1 envelope of a chain pulled from a one-process
server, re-exported, byte for byte; ``graph_captures`` stays flat after
``prewarm``.

A chain the tensor-parallel engine computed itself is the one-process
engine's byte for byte in layer 0. Past it, each layer's K/V comes
through the row-parallel output projection, summed over the ranks in
another order than one process sums it, so its float32 values, and the
per-token int8 scales taken from them, may differ in the last bits:
there the scales are held to ``rtol=1e-6`` and the int8 values to one
step.
"""

import dataclasses
import socket
import threading

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from devspace_tpu.inference import InferenceEngine as JaxEngine
from devspace_tpu.models import transformer as jtfm
from devspace_tpu.parallel.mesh import create_mesh as jcreate_mesh
from devspace_tpu_torch import serve
from devspace_tpu_torch.inference import InferenceEngine
from devspace_tpu_torch.inference.kv_tier import unpack_chain_envelope, unpack_kv_payload
from devspace_tpu_torch.inference.prefix_cache import fingerprint_chain
from devspace_tpu_torch.models import transformer as ttfm
from devspace_tpu_torch.models.convert import params_from_numpy
import torch_parallel_workers as w
from test_torch_kv_tier_engine import _spill_restore_trace
from test_torch_parallel_tp import TINY32, np_tree
from torch_parallel_world import World

ENGINE = dict(max_slots=1, max_len=64, block_size=8, n_blocks=9, prefill_chunk=8, chunk_max=4,
              kv_dtype="int8")
# the migration leg: 5 full blocks at block_size 8, 4 of them pulled
PROMPT = [(7 * i) % 49 + 1 for i in range(40)]
PULLED = PROMPT[:32]
N_NEW = 8
RUN_TIMEOUT = 240.0


@pytest.fixture(scope="module")
def world(tmp_path_factory):
    wd = World(2, tmp_path_factory.mktemp("gloo"))
    yield wd
    wd.close()


@pytest.fixture(scope="module")
def params_np():
    return np_tree(jtfm.init_params(dataclasses.replace(jtfm.TINY, dtype=jnp.float32),
                                    jax.random.PRNGKey(0)))


@pytest.fixture(scope="module")
def trace():
    reqs, waves = _spill_restore_trace()
    # the shared prompt's chain (restored, resident) and the first flood
    # prompt's (spilled to the tier)
    return reqs, waves, [reqs[0]["prompt_ids"], reqs[1]["prompt_ids"]]


def port_cfg():
    return ttfm.TransformerConfig(**TINY32, dtype=torch.float32)


def one_process(params_np, reqs, waves, exports, tier="host", **kw):
    """The one-process port engine over the same traffic -> (streams,
    counters, envelopes)."""
    engine = InferenceEngine(params_from_numpy(params_np, "cpu"), port_cfg(), device="cpu",
                             kv_tier=tier, **{**ENGINE, **kw}).start()
    try:
        streams = []
        for lo, hi in waves:
            streams.extend(h.result(timeout=120) for h in [engine.submit(**r) for r in reqs[lo:hi]])
        envelopes = [engine.export_kv_chain(fingerprint_chain(p, 8)[-1], timeout=60)
                     for p in exports]
        st = engine.stats()
    finally:
        engine.stop()
    return streams, {k: st[k] for k in w.TIER_KEYS}, envelopes


@pytest.fixture(scope="module", params=["host", "host+disk"])
def tp_run(request, world, params_np, trace, tmp_path_factory):
    reqs, waves, exports = trace
    tier_dir = str(tmp_path_factory.mktemp("tier")) if request.param == "host+disk" else None
    kw = dict(kv_tier_bytes=4096) if tier_dir else {}
    got = world.run(w.engine_tp_tier, params_np, TINY32, reqs, waves, {**ENGINE, **kw},
                    request.param, tier_dir, exports, timeout=RUN_TIMEOUT)
    want = one_process(params_np, reqs, waves, exports, request.param,
                       **(dict(kv_tier_bytes=4096, kv_tier_dir=str(tmp_path_factory.mktemp("one")))
                          if tier_dir else {}))
    return request.param, got, want


def test_tp_tier_streams_and_counters_equal_the_one_process_engines(tp_run):
    tier, got, (streams, stats, _) = tp_run
    assert stats["kv_spill_blocks"] > 0 and stats["kv_restore_hits"] >= 3
    for rank, r in enumerate(got):
        assert r["streams"] == streams, rank
        assert r["stats"] == stats, rank
        assert r["captures"][0] == r["captures"][1] > 0, rank
        assert r["pool_heads"] == 1  # TINY's 2 KV heads, one a rank
    assert got[0]["tier_entries"] > 0 and got[1]["tier_entries"] == 0  # rank 0 holds the tier


def test_tp_kvm1_exports_carry_every_head(tp_run, trace):
    """The restored shared chain (gathered from both ranks' pools) and a
    spilled one (read from rank 0's tier) against the one-process
    engine's envelopes (the module docstring's tolerance past layer 0)."""
    _, got, (_, _, envelopes) = tp_run
    assert all(e is not None for e in envelopes) and len(got[0]["envelopes"]) == 2
    for env_tp, env, prompt in zip(got[0]["envelopes"], envelopes, trace[2]):
        blocks_tp, blocks = unpack_chain_envelope(env_tp), unpack_chain_envelope(env)
        assert [d for d, _ in blocks_tp] == [d for d, _ in blocks] == fingerprint_chain(prompt, 8)
        for (_, p_tp), (_, p) in zip(blocks_tp, blocks):
            assert len(p_tp) == len(p)
            for x_tp, x in zip(unpack_kv_payload(p_tp), unpack_kv_payload(p)):
                np.testing.assert_array_equal(x_tp[0], x[0])  # every head of layer 0
                if x.dtype == np.int8:
                    assert np.abs(x_tp[1:].astype(np.int16) - x[1:]).max() <= 1
                else:
                    np.testing.assert_allclose(x_tp[1:], x[1:], rtol=1e-6, atol=0)


def test_tp_tier_counters_equal_the_jax_engines(tp_run, params_np, trace, tmp_path):
    """The JAX engine over its own ``{model: 2}`` mesh, whose tier is built
    as without one, on the same tier."""
    tier, got, _ = tp_run
    reqs, waves, _ = trace
    jcfg = dataclasses.replace(jtfm.TINY, dtype=jnp.float32)
    mesh = jcreate_mesh({"model": 2}, devices=jax.devices()[:2])
    kw = dict(kv_tier_bytes=4096, kv_tier_dir=str(tmp_path)) if tier == "host+disk" else {}
    engine = JaxEngine(jax.tree.map(jnp.asarray, params_np), jcfg, kv_tier=tier, mesh=mesh,
                       **ENGINE, **kw).start()
    try:
        theirs = []
        for lo, hi in waves:
            theirs.extend(h.result(timeout=300) for h in [engine.submit(**r) for r in reqs[lo:hi]])
        jst = engine.stats()
    finally:
        engine.stop()
    keys = ("kv_spill_blocks", "kv_spill_bytes", "kv_restore_hits", "kv_restore_fallbacks",
            "recompute_tokens_saved", "prefix_hit_tokens", "kv_tier_spilled_nodes")
    assert {k: got[0]["stats"][k] for k in keys} == {k: jst[k] for k in keys}
    assert got[0]["streams"][:len(theirs)] == theirs


@pytest.fixture(scope="module")
def source(params_np):
    """A one-process port engine behind its HTTP server that has served
    ``PROMPT``: the KVM1 source of a pull -> (url, its stream, its
    envelope of the blocks a pull takes)."""
    engine = InferenceEngine(params_from_numpy(params_np, "cpu"), port_cfg(), device="cpu",
                             kv_tier="host", **{**ENGINE, "max_slots": 2, "n_blocks": 10}).start()
    server = serve.Server(engine, "tiny")
    httpd = serve.make_http_server(server, "127.0.0.1", 0)
    thread = threading.Thread(target=httpd.serve_forever, daemon=True)
    thread.start()
    try:
        cold = engine.submit(PROMPT, N_NEW).result(timeout=120)
        envelope = engine.export_kv_chain(fingerprint_chain(PULLED, 8)[-1])
        yield f"http://127.0.0.1:{httpd.server_address[1]}", cold, envelope
    finally:
        httpd.shutdown()
        httpd.server_close()
        server.close()
        engine.stop()
        thread.join(timeout=30)


def closed_port_url() -> str:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        port = s.getsockname()[1]
    return f"http://127.0.0.1:{port}"


@pytest.mark.parametrize("dead", [False, True], ids=["live", "dead"])
def test_a_kv_source_pull_gives_the_recomputed_stream(world, params_np, source, dead):
    """A live source: rank 0 pulls the 4-block chain, both ranks restore
    their heads of it, the stream is the recomputed one, and rank 0's
    export of the pulled chain is the source's, byte for byte. A dead
    source: the pull fails on rank 0, both ranks recompute, neither
    hangs, and the stream is the same."""
    url, cold, envelope = source
    pull = dict(prompt_ids=PROMPT, max_new_tokens=N_NEW,
                kv_source=closed_port_url() if dead else url)
    got = world.run(w.engine_tp_tier, params_np, TINY32, [], [], ENGINE, "host", None, [PULLED],
                    [pull], timeout=RUN_TIMEOUT)
    for rank, r in enumerate(got):
        assert r["streams"] == [cold], rank
        st = r["stats"]
        if dead:
            assert (st["kv_migrate_chains"], st["kv_migrate_failures"]) == (0, 1), rank
            assert st["kv_restore_hits"] == 0 and st["kv_restore_fallbacks"] >= 1, rank
        else:
            assert (st["kv_migrate_chains"], st["kv_migrate_blocks"],
                    st["kv_migrate_failures"]) == (1, 4, 0), rank
            assert st["kv_restore_hits"] == 4 and st["recompute_tokens_saved"] == 32, rank
        assert st["kv_tier_remote_nodes"] == 0 and st["requests_failed"] == 0, rank
        assert st["kv_export_chains"] == 1, rank
    assert got[0]["stats"] == got[1]["stats"]
    if not dead:
        assert got[0]["envelopes"] == [envelope]
