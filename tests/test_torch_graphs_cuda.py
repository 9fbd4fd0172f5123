"""The serving engine's programs as CUDA graphs, on the card
(devspace_tpu_torch/inference/graphs.py). Imports no JAX; skips where
there is no CUDA device. Run on the card with

    python -m pytest -m cuda tests/test_torch_graphs_cuda.py

- A replayed decode-chunk graph gives, bit for bit, the tokens, carry
  and pool writes of the same function run eagerly over the same
  buffers, on bf16 TINY, in all three sampling modes; so does the
  spec-round graph (draft-cache writes too).
- A graph follows table and length changes made in place (a prefix hit
  pointing a row at another row's blocks): no block id or position is
  baked in.
- Each replay accounts ``n_layers x k`` paged-decode launches (a spec
  round ``n_layers x spec_depth``), and the wrapper's own count moves
  only while a graph is captured.
- The engine survives a failed dispatch: the pool and the draft cache
  are zeroed in place, no graph is recaptured, and the next request's
  stream equals a fresh engine's.
- End to end: float32 TINY served through graphs at depth 1 and 2 equals
  greedy ``generate`` on the card, with and without a draft.
- ``lint.runtime.CompileWatch`` counts the engine's real captures: every
  program ``prewarm`` captures, none in the waves served after it, one
  for a program key first reached after a ``reset()``.
- With the host KV tier on an int8 pool, a spill and a restore after
  ``prewarm`` capture no graph and leave the pool's buffers where the
  graphs hold them: the chunks replayed after the restore decode the
  restored K/V, and the stream equals the tier-off stream.

Block 0 is scratch (parked rows all write position 0 of it), so pool
comparisons skip it.
"""

import dataclasses

import pytest
import torch

from devspace_tpu_torch.inference import InferenceEngine
from devspace_tpu_torch.inference.engine import MODES
from devspace_tpu_torch.lint.runtime import CompileWatch, RecompileError
from devspace_tpu_torch.models import transformer as tfm
from devspace_tpu_torch.ops import paged_attention as pa

BF16 = tfm.TINY
F32 = dataclasses.replace(tfm.TINY, dtype=torch.float32)
B, MAX_LEN, BS = 4, 128, 16


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return torch.device("cuda")


def make_engine(dev, cfg=BF16, draft=False, **kw):
    params = tfm.init_params(cfg, torch.Generator(device=dev).manual_seed(0))
    extra = dict(draft_params=params, draft_cfg=cfg, spec_k=3, spec_depth=2) if draft else {}
    return InferenceEngine(params, cfg, device=dev, max_slots=B, max_len=MAX_LEN, block_size=BS,
                           **extra, **kw)


def set_state(engine, mode, seed=0):
    """Random pool and draft cache; rows 0, 1 and 3 active at distinct
    positions with their own blocks, row 2 parked; per-row sampling
    state for ``mode``."""
    g = torch.Generator(device=engine.device).manual_seed(seed)
    for t in engine.pool.values():
        t.copy_(torch.randn(t.shape, generator=g, device=t.device).to(t.dtype))
    if engine._draft_cache is not None:
        for key in ("k", "v"):
            t = engine._draft_cache[key]
            t.copy_(torch.randn(t.shape, generator=g, device=t.device).to(t.dtype))
    d = engine._dispatcher
    c = d.carry
    mb = engine.max_blocks
    c["tables"].copy_(torch.arange(1, 1 + B * mb, dtype=torch.int32, device=engine.device)
                      .view(B, mb))
    c["positions"].copy_(torch.tensor([5, 40, 0, 97], device=engine.device))
    c["tokens"].copy_(torch.tensor([3, 17, 0, 200], device=engine.device))
    c["seeds"].copy_(torch.tensor([11, 12, 13, 14], device=engine.device))
    sampled = mode != "greedy"
    c["temps"].copy_(torch.tensor([0.8 if sampled else 0.0, 0.0, 0.0, 1.1 if sampled else 0.0],
                                  device=engine.device))
    filt = mode == "filters"
    c["top_ks"].copy_(torch.tensor([5 if filt else 0, 0, 0, 0], device=engine.device))
    c["top_ps"].copy_(torch.tensor([1.0, 1.0, 1.0, 0.9 if filt else 1.0], device=engine.device))
    d.active.copy_(torch.tensor([True, True, False, True], device=engine.device))


def snapshot(engine):
    d = engine._dispatcher
    out = {"pool": {k: v[:, 1:].clone() for k, v in engine.pool.items()},
           "carry": {k: v.clone() for k, v in d.carry.items()},
           "toks": d.toks_out.clone()}
    if engine._draft_cache is not None:
        # the scratch tail past max_len takes the parked row's writes
        out["draft"] = {k: engine._draft_cache[k][:, :, :MAX_LEN].clone() for k in ("k", "v")}
        out["spec"] = engine._spec_out.clone()
    return out


def assert_same(a, b):
    for key in a:
        if isinstance(a[key], dict):
            for name in a[key]:
                assert torch.equal(a[key][name], b[key][name]), (key, name)
        else:
            assert torch.equal(a[key], b[key]), key


def eager_then_replay(engine, key, mode, run_eager):
    set_state(engine, mode)
    with torch.no_grad():
        run_eager()
    torch.cuda.synchronize()
    want = snapshot(engine)
    for _ in range(2):  # the capture's replay, then a second replay
        set_state(engine, mode)
        engine._programs.run(key)
        torch.cuda.synchronize()
        assert_same(want, snapshot(engine))
    return want


@pytest.mark.cuda
@pytest.mark.parametrize("mode", MODES)
def test_decode_graph_replays_bit_for_bit(dev, mode):
    engine = make_engine(dev)
    k = 4
    want = eager_then_replay(engine, ("decode", k, mode),
                             mode, lambda: engine._decode_program(k, mode))
    # the active rows advanced by k, the parked row did not
    assert want["carry"]["positions"].tolist() == [5 + k, 40 + k, 0, 97 + k]
    assert engine.stats()["graph_captures"] == 1


@pytest.mark.cuda
@pytest.mark.parametrize("mode", MODES)
def test_spec_graph_replays_bit_for_bit(dev, mode):
    engine = make_engine(dev, draft=True)
    want = eager_then_replay(engine, ("spec", mode), mode, lambda: engine._spec_program(mode))
    counts = want["spec"][:, :, -1]  # [rounds, B]: 1..k+1 committed a round
    assert ((counts >= 1) & (counts <= 4)).all()
    positions = want["carry"]["positions"].tolist()
    assert positions[2] == 0 and positions[0] == 5 + int(counts[:, 0].sum())


@pytest.mark.cuda
def test_graph_follows_in_place_table_and_length_changes(dev):
    """Capture, then point row 3's first two table entries at row 0's
    blocks (what a prefix hit does) and move every position: the replay
    equals an eager run of the changed state."""
    engine = make_engine(dev)
    key = ("decode", 2, "greedy")
    set_state(engine, "greedy")
    engine._programs.run(key)  # captured over the first state

    def changed():
        set_state(engine, "greedy", seed=1)
        c = engine._dispatcher.carry
        c["tables"][3, :2] = c["tables"][0, :2]
        c["positions"].copy_(torch.tensor([60, 2, 0, 33], device=dev))

    changed()
    with torch.no_grad():
        engine._decode_program(2, "greedy")
    torch.cuda.synchronize()
    want = snapshot(engine)
    changed()
    engine._programs.run(key)
    torch.cuda.synchronize()
    assert_same(want, snapshot(engine))
    assert engine.stats()["graph_captures"] == 1


@pytest.mark.cuda
def test_replay_launch_count(dev):
    engine = make_engine(dev, draft=True)
    set_state(engine, "greedy")
    engine.prewarm()
    captured = pa.LAUNCHES
    before = engine.stats()["paged_decode_launches"]
    for k in (1, 2, 4, 8):
        engine._programs.run(("decode", k, "sampled"))
    engine._programs.run(("spec", "greedy"))
    torch.cuda.synchronize()
    assert pa.LAUNCHES == captured, "a replay went through the wrapper"
    n = BF16.n_layers
    assert engine.stats()["paged_decode_launches"] - before == n * (1 + 2 + 4 + 8) + n * 2
    assert pa.LAST_DISPATCH["impl"] == "cuda"


def serve(engine, requests):
    engine.start()
    try:
        handles = [engine.submit(p, n) for p, n in requests]
        return [h.result(timeout=300) for h in handles], engine.stats()
    finally:
        engine.stop()


@pytest.mark.cuda
def test_engine_survives_reset_pool_after_forced_failure(dev):
    engine = make_engine(dev, draft=True, prewarm=True)
    pointers = [t.data_ptr() for t in engine.pool.values()]
    calls = {"n": 0}
    real = engine._programs.run

    def flaky(key):
        calls["n"] += 1
        if calls["n"] == 2:
            raise RuntimeError("injected dispatch fault")
        return real(key)

    engine._programs.run = flaky
    engine.start()
    try:
        h1 = engine.submit([5, 1, 4], 24)
        h2 = engine.submit([2, 9], 24, logit_bias={7: 1.0})  # the plain path
        for h in (h1, h2):
            with pytest.raises(RuntimeError, match="failed"):
                h.result(timeout=300)
        got = engine.submit([7, 7, 7], 12).result(timeout=300)
        st = engine.stats()
    finally:
        engine.stop()
    assert st["requests_failed"] == 2 and st["requests_completed"] == 1
    assert st["graph_captures"] == len(engine._programs.keys()), "a graph was recaptured"
    assert [t.data_ptr() for t in engine.pool.values()] == pointers
    fresh, _ = serve(make_engine(dev, draft=True), [([7, 7, 7], 12)])
    assert got == fresh[0]


@pytest.mark.cuda
@pytest.mark.parametrize("draft", [False, True], ids=["plain", "spec"])
def test_engine_streams_equal_generate(dev, draft):
    """Float32 TINY with TF32 off: greedy streams through replayed graphs,
    at depth 1 and 2, equal greedy ``generate`` on the card (under the
    ~38-token exact tie of the TINY/seed-0 trajectory)."""
    requests = [([5, 1, 4], 20), ([2, 9, 9], 16), ([7, 3], 24), (list(range(1, 21)), 12)]
    streams = {}
    for depth in (1, 2):
        engine = make_engine(dev, F32, draft=draft, dispatch_depth=depth)
        streams[depth], st = serve(engine, requests)
        assert st["requests_failed"] == 0 and (st["spec_rounds"] > 0) == draft
        assert st["graph_captures"] > 0
    assert streams[1] == streams[2]
    params = tfm.init_params(F32, torch.Generator(device=dev).manual_seed(0))
    for (prompt, n), got in zip(requests, streams[2]):
        with torch.no_grad():
            want = tfm.generate(params, torch.tensor([prompt], device=dev), F32, n)
        assert got == want[0].tolist()


def kv_tier_waves(seed=0):
    """A 48-token shared prompt (3 blocks of 16), two distinct 96-token
    prompts that evict it (spilling it with the tier on), then the shared
    prompt with a tail of its own, which restores its 3 blocks."""
    g = torch.Generator().manual_seed(seed)
    shared = torch.randint(1, 256, (48,), generator=g).tolist()
    distinct = [torch.randint(1, 256, (96,), generator=g).tolist() for _ in range(2)]
    return [shared, *distinct, shared + torch.randint(1, 256, (8,), generator=g).tolist()]


@pytest.mark.cuda
def test_kv_tier_restore_decodes_through_the_graphs(dev):
    """With the host tier on an int8 pool, after ``prewarm``: the waves
    spill the shared chain and restore it, no graph is captured, and the
    replayed chunks after the restore decode the restored K/V (the stream
    equals the tier-off stream: a restore that rebound the pool would
    leave the graphs reading the old one)."""
    params = tfm.init_params(BF16, torch.Generator(device=dev).manual_seed(0))
    waves = kv_tier_waves()
    streams, stats = {}, {}
    for tier in ("off", "host"):
        engine = InferenceEngine(params, BF16, device=dev, max_slots=1, max_len=MAX_LEN,
                                 block_size=BS, n_blocks=1 + MAX_LEN // BS, kv_dtype="int8",
                                 kv_tier=tier)
        engine.prewarm()
        captures = engine.stats()["graph_captures"]
        pool = {k: t.data_ptr() for k, t in engine.pool.items()}
        engine.start()
        try:
            streams[tier] = [engine.submit(p, 16).result(timeout=300) for p in waves[:3]]
            before = engine.stats()
            streams[tier].append(engine.submit(waves[3], 16).result(timeout=300))
            st = engine.stats()
        finally:
            engine.stop()
        assert st["graph_captures"] == captures
        assert {k: t.data_ptr() for k, t in engine.pool.items()} == pool
        assert st["paged_decode_launches"] - before["paged_decode_launches"] == BF16.n_layers * 15
        stats[tier] = st
    assert stats["host"]["kv_spill_blocks"] > 0
    assert stats["host"]["kv_restore_hits"] == 3 and stats["host"]["kv_restore_fallbacks"] == 0
    assert stats["off"]["kv_restore_hits"] == 0
    assert streams["host"] == streams["off"]


@pytest.mark.cuda
def test_compile_watch_counts_captures_on_the_card(dev):
    engine = make_engine(dev)
    with CompileWatch("card") as watch:
        engine.prewarm()
        assert watch.count == engine.stats()["graph_captures"] == len(engine._programs.keys())
        watch.reset()
        engine.start()
        try:
            for h in [engine.submit(list(range(1, 9 + i)), 12) for i in range(3)]:
                h.result(timeout=300)
            assert watch.count == 0
            assert engine.stats()["paged_decode_launches"] > 0
        finally:
            engine.stop()
    watch.assert_no_recompiles()
    # a table built without prewarm captures at first use, one key a capture
    fresh = make_engine(dev)
    watch = CompileWatch("first use").start()
    key = fresh._programs.keys()[0]
    fresh._programs.run(key)
    fresh._programs.run(key)
    torch.cuda.synchronize()
    assert watch.stop() == 1 == fresh.stats()["graph_captures"]
    with pytest.raises(RecompileError):
        watch.assert_no_recompiles()
