"""``InferenceEngine.prewarm()`` of the port on the CPU (float32 TINY,
JAX weights converted through numpy), mirroring tests/test_inference.py's
prewarm tests: prewarm builds every program serving can reach (on the
card it captures each decode chunk and spec round as a CUDA graph; on the
CPU ``captures`` counts first uses), so the count stays flat across a
serving mix that exercises a cold prefill, a prefix-shifted tail with the
table-edge bucket shrink, every chunk size, filtered sampling, the
sampling extras and spec rounds; it refuses a running engine; and the
server's ``PREWARM=1`` and ``ENGINE_OVERLAP=off`` knobs reach the engine.
"""

import dataclasses
import json
import os
import re
import socket
import subprocess
import sys
import time
import urllib.request

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from devspace_tpu.models import transformer as jtfm
from devspace_tpu_torch.inference import InferenceEngine
from devspace_tpu_torch.models import transformer as ttfm
from devspace_tpu_torch.models.convert import params_from_numpy

JCFG = dataclasses.replace(jtfm.TINY, dtype=jnp.float32)
CFG = dataclasses.replace(ttfm.TINY, dtype=torch.float32)
REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TIMEOUT = 300


@pytest.fixture(scope="module")
def params():
    jparams = jtfm.init_params(JCFG, jax.random.PRNGKey(0))
    return params_from_numpy(jax.tree.map(np.asarray, jparams), "cpu")


def test_prewarm_builds_every_program_and_captures_stay_flat(params, monkeypatch):
    engine = InferenceEngine(params, CFG, device="cpu", max_slots=2, max_len=46, block_size=4,
                             prefill_chunk=16, draft_params=params, draft_cfg=CFG, prewarm=True)
    used = []
    real = engine._programs.run

    def spy(key):
        used.append(key)
        return real(key)

    monkeypatch.setattr(engine._programs, "run", spy)
    engine.start()
    built = engine.stats()["graph_captures"]
    # decode: chunk sizes 1, 2, 4, 8 x three modes; spec: three modes
    assert built == 15 == len(engine._programs.keys())
    try:
        rng = np.random.default_rng(3)
        base = rng.integers(1, CFG.vocab_size, size=45).tolist()
        # cold prefill + greedy spec rounds
        engine.submit(base[:20], 4).result(timeout=TIMEOUT)
        # shares a 5-block prefix: prefill starts at offset 20 and its
        # tail hits the table edge (t_alloc 48, bucket 16 > span 12)
        engine.submit(base, 1).result(timeout=TIMEOUT)
        # top-k filtered sampling on the spec path, sampled and filtered
        # plain chunks beside it (logit_bias keeps a slot off spec)
        handles = [
            engine.submit(base[:5], 6, temperature=0.7, top_k=5, seed=1),
            engine.submit(base[:6], 15, temperature=0.9, seed=2, logit_bias={3: 0.5}),
        ]
        [h.result(timeout=TIMEOUT) for h in handles]
        engine.submit(base[:7], 9, temperature=0.9, top_p=0.8, seed=4,
                      logit_bias={3: 0.5}).result(timeout=TIMEOUT)
        # sampling extras on greedy plain chunks of every size
        engine.submit(base[:5], 15, eos_id=3, min_new_tokens=15,
                      logit_bias={7: 2.0}).result(timeout=TIMEOUT)
        engine.submit(base[:3], 2, logit_bias={7: 1.0}).result(timeout=TIMEOUT)
        st = engine.stats()
    finally:
        engine.stop()
    assert st["graph_captures"] == built, "serving built a program after prewarm"
    assert st["requests_failed"] == 0 and st["prefix_hit_blocks"] >= 5
    assert {key[1] for key in used if key[0] == "decode"} == {1, 2, 4, 8}
    assert {key[-1] for key in used if key[0] == "decode"} == {"greedy", "sampled", "filters"}
    assert ("spec", "greedy") in used and ("spec", "filters") in used


def test_prewarm_timings_name_every_program(params):
    engine = InferenceEngine(params, CFG, device="cpu", max_slots=2, max_len=46, block_size=4,
                             prefill_chunk=16, draft_params=params, draft_cfg=CFG)
    timings = engine.prewarm()
    assert all(t >= 0 for t in timings.values())
    # prefill buckets up to prefill_chunk (16 fits the 48-position table);
    # draft buckets up to max_len, which is one itself
    assert [k for k in timings if k.startswith("prefill_")] == [
        f"prefill_{c}" for c in (1, 2, 4, 8, 16)]
    assert [k for k in timings if k.startswith("draft_prefill_")] == [
        f"draft_prefill_{c}" for c in (1, 2, 4, 8, 16, 32, 46)]
    assert {k for k in timings if k.startswith(("decode_", "spec_"))} == {
        *(f"decode_{k}_{m}" for k in (1, 2, 4, 8) for m in ("greedy", "sampled", "filters")),
        "spec_greedy", "spec_sampled", "spec_filters"}
    assert engine.stats()["graph_captures"] == 15
    # the pool is untouched outside scratch block 0
    assert not engine.pool["k"][:, 1:].any() and not engine.pool["v"][:, 1:].any()
    assert engine.prewarm().keys() == timings.keys()  # again: nothing new is built
    assert engine.stats()["graph_captures"] == 15


def test_prewarm_refuses_running_engine(params):
    engine = InferenceEngine(params, CFG, device="cpu", max_slots=1, max_len=32).start()
    try:
        with pytest.raises(RuntimeError, match="before start"):
            engine.prewarm()
    finally:
        engine.stop()


def test_server_prewarm_and_overlap_knobs():
    """``PREWARM=1`` builds every program before the port opens and
    ``ENGINE_OVERLAP=off`` gives the serial loop; TINY drafts for itself."""
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        port = s.getsockname()[1]
    env = {**os.environ, "MODEL": "tiny", "MAX_SLOTS": "1", "PREWARM": "1",
           "ENGINE_OVERLAP": "off"}
    proc = subprocess.Popen(
        [sys.executable, "-m", "devspace_tpu_torch.serve", "--port", str(port),
         "--host", "127.0.0.1", "--device", "cpu"],
        cwd=REPO, env=env, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
    )
    url = f"http://127.0.0.1:{port}"
    try:
        deadline = time.monotonic() + 120
        while True:
            try:
                with urllib.request.urlopen(url + "/healthz", timeout=2) as resp:
                    health = json.loads(resp.read())
                break
            except OSError:
                assert proc.poll() is None, proc.stdout.read().decode()
                assert time.monotonic() < deadline, "server did not come up"
                time.sleep(0.2)
        assert health["dispatch_depth"] == 1 and health["graph_captures"] == 15
        body = json.dumps({"prompt_ids": [5, 1, 4], "max_new_tokens": 6}).encode()
        with urllib.request.urlopen(urllib.request.Request(url + "/generate", data=body),
                                    timeout=60) as resp:
            assert len(json.loads(resp.read())["tokens"]) == 6
        with urllib.request.urlopen(url + "/healthz", timeout=10) as resp:
            assert json.loads(resp.read())["graph_captures"] == 15
    finally:
        proc.terminate()
        proc.wait(timeout=10)
    # TINY: prefill and draft buckets 1..128, 12 decode and 3 spec programs
    assert re.search(rb"prewarmed 31 programs in", proc.stdout.read())
