"""The port's HTTP server (devspace_tpu_torch/serve.py) on the CPU with
TINY: the reference server's contract — /generate (JSON and ndjson
stream), /healthz, /readyz and /drain, /generate_speculative (greedy
through the engine's speculative path; 400 on sampling fields, 501
without a draft), 404 elsewhere; and with the host KV tier (--kv-tier or
DEVSPACE_KV_TIER) /prefill, /kv/chain/<digest> and /generate's
kv_source, which pulls a chain from a second in-process server and
falls back to recomputing when the source is dead."""

import contextlib
import json
import os
import socket
import subprocess
import sys
import threading
import time
import urllib.error
import urllib.request

import pytest

from devspace_tpu_torch import serve
from devspace_tpu_torch.inference.kv_tier import unpack_chain_envelope
from devspace_tpu_torch.inference.prefix_cache import fingerprint_chain

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.fixture(scope="module")
def url():
    engine = serve.build_engine("tiny", device="cpu", max_slots=2).start()
    httpd = serve.make_http_server(serve.Server(engine, "tiny"), "127.0.0.1", 0)
    thread = threading.Thread(target=httpd.serve_forever, daemon=True)
    thread.start()
    try:
        yield f"http://127.0.0.1:{httpd.server_address[1]}"
    finally:
        httpd.shutdown()
        httpd.server_close()
        engine.stop()
        thread.join(timeout=10)
        assert not thread.is_alive()


@pytest.fixture(scope="module")
def spec_url():
    """TINY drafting for itself (the server's default draft policy)."""
    engine = serve.build_engine("tiny", device="cpu", max_slots=2, draft_model="tiny",
                                spec_k=3).start()
    httpd = serve.make_http_server(serve.Server(engine, "tiny"), "127.0.0.1", 0)
    thread = threading.Thread(target=httpd.serve_forever, daemon=True)
    thread.start()
    try:
        yield f"http://127.0.0.1:{httpd.server_address[1]}"
    finally:
        httpd.shutdown()
        httpd.server_close()
        engine.stop()
        thread.join(timeout=10)


@contextlib.contextmanager
def serving(engine):
    engine.start()
    httpd = serve.make_http_server(serve.Server(engine, "tiny"), "127.0.0.1", 0)
    thread = threading.Thread(target=httpd.serve_forever, daemon=True)
    thread.start()
    try:
        yield f"http://127.0.0.1:{httpd.server_address[1]}"
    finally:
        httpd.shutdown()
        httpd.server_close()
        engine.stop()
        thread.join(timeout=10)


@pytest.fixture(scope="module")
def tier_urls():
    """Four TINY servers with the host tier on an int8 pool (exact
    restores): a prefill source, a cold one, a decode replica pulling
    from the source and one whose source is dead."""
    with contextlib.ExitStack() as stack:
        yield [stack.enter_context(serving(serve.build_engine(
            "tiny", device="cpu", max_slots=2, kv_dtype="int8", kv_tier="host")))
            for _ in range(4)]


def call(url, path, body=None, timeout=60):
    data = None if body is None else json.dumps(body).encode()
    req = urllib.request.Request(url + path, data=data, method="POST" if data is not None else "GET")
    try:
        with urllib.request.urlopen(req, timeout=timeout) as resp:
            return resp.status, resp.read()
    except urllib.error.HTTPError as e:
        return e.code, e.read()


def test_generate_plain_and_stream_agree(url):
    body = {"prompt_ids": [5, 1, 4], "max_new_tokens": 6}
    code, raw = call(url, "/generate", body)
    assert code == 200
    tokens = json.loads(raw)["tokens"]
    assert len(tokens) == 6 and all(0 <= t < 256 for t in tokens)
    code, raw = call(url, "/generate", {**body, "stream": True})
    assert code == 200
    lines = [json.loads(line) for line in raw.decode().splitlines()]
    assert lines[-1] == {"done": True}
    assert [line["token"] for line in lines[:-1]] == tokens


def test_generate_sampling_fields_and_bad_input(url):
    body = {"prompt_ids": [3, 3], "max_new_tokens": 5, "temperature": 0.8, "top_p": 0.9,
            "seed": 4, "logit_bias": {"9": 1e9}}
    code, raw = call(url, "/generate", body)
    assert code == 200 and json.loads(raw)["tokens"] == [9] * 5
    assert call(url, "/generate", {"max_new_tokens": 3})[0] == 400  # no prompt
    assert call(url, "/generate", {"prompt_ids": [1], "max_new_tokens": 10_000})[0] == 400


def test_healthz_drain_readyz(url):
    code, raw = call(url, "/healthz")
    health = json.loads(raw)
    assert code == 200 and health["ok"] and health["model"] == "tiny"
    assert health["device"] == "cpu" and health["max_slots"] == 2
    assert "requests_completed" in health and "free_blocks" in health
    assert call(url, "/readyz")[0] == 200
    assert json.loads(call(url, "/drain", {})[1]) == {"draining": True}
    assert call(url, "/readyz")[0] == 503
    assert call(url, "/healthz")[0] == 200  # alive while not routable
    assert json.loads(call(url, "/drain", {"off": True})[1]) == {"draining": False}
    assert call(url, "/readyz")[0] == 200


def test_speculative_501_and_unknown_404(url):
    assert call(url, "/generate_speculative", {"prompt_ids": [1], "max_new_tokens": 2})[0] == 501
    assert call(url, "/nope")[0] == 404
    assert call(url, "/nope", {})[0] == 404


def test_generate_speculative_equals_generate(url, spec_url):
    body = {"prompt_ids": [5, 1, 4], "max_new_tokens": 12}
    code, raw = call(spec_url, "/generate_speculative", body)
    assert code == 200
    reply = json.loads(raw)
    plain = json.loads(call(url, "/generate", body)[1])["tokens"]  # the server without a draft
    assert reply["tokens"] == plain == json.loads(call(spec_url, "/generate", body)[1])["tokens"]
    stats = reply["speculative"]
    assert set(stats) == {"rounds", "acceptance_rate", "tokens_per_round"}
    assert stats["rounds"] > 0 and 0.0 <= stats["acceptance_rate"] <= 1.0
    assert stats["tokens_per_round"] >= 1.0
    health = json.loads(call(spec_url, "/healthz")[1])
    assert health["spec_rounds"] >= stats["rounds"] and health["draft_prefills"] >= 2


@pytest.mark.parametrize("field,value", [("temperature", 0.0), ("eos_id", 0), ("top_k", 0),
                                         ("top_p", 1.0), ("stream", False), ("stop", [[1]]),
                                         ("min_new_tokens", 0), ("logit_bias", {})])
def test_generate_speculative_refuses_sampling_fields_by_presence(spec_url, field, value):
    body = {"prompt_ids": [5, 1, 4], "max_new_tokens": 4, field: value}
    code, raw = call(spec_url, "/generate_speculative", body)
    assert code == 400 and field in json.loads(raw)["error"]


def test_generate_speculative_k_and_bad_input(spec_url):
    ok = {"prompt_ids": [3, 3], "max_new_tokens": 3}
    assert call(spec_url, "/generate_speculative", {**ok, "k": 3})[0] == 200  # the engine's k
    assert call(spec_url, "/generate_speculative", {**ok, "k": 4})[0] == 400
    assert call(spec_url, "/generate_speculative", {**ok, "k": 99})[0] == 400
    assert call(spec_url, "/generate_speculative", {"max_new_tokens": 3})[0] == 400  # no prompt
    assert call(spec_url, "/generate_speculative", {**ok, "max_new_tokens": 0})[0] == 400
    assert call(spec_url, "/generate_speculative", {**ok, "max_new_tokens": 10_000})[0] == 400


def test_draft_policy_from_env(monkeypatch):
    for name in ("SPEC", "DRAFT_MODEL", "DRAFT_CHECKPOINT"):
        monkeypatch.delenv(name, raising=False)
    assert serve.draft_model_from_env("tiny") == "tiny"  # tiny drafts for itself
    assert serve.draft_model_from_env("llama2-7b") is None
    monkeypatch.setenv("DRAFT_MODEL", "llama2-13b")
    assert serve.draft_model_from_env("llama2-7b") == "llama2-13b"
    monkeypatch.setenv("SPEC", "0")
    assert serve.draft_model_from_env("tiny") is None
    monkeypatch.setenv("DRAFT_CHECKPOINT", "runs/draft")
    with pytest.raises(SystemExit, match="DRAFT_CHECKPOINT"):
        serve.draft_model_from_env("tiny")


def test_build_engine_checks_the_draft():
    with pytest.raises(ValueError, match="DRAFT_MODEL"):
        serve.build_engine("tiny", device="cpu", draft_model="nope")
    with pytest.raises(ValueError, match="vocab"):
        serve.build_engine("tiny", device="cpu", draft_model="llama2-7b")


def test_module_entry_point_takes_port():
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        port = s.getsockname()[1]
    env = {**os.environ, "MODEL": "tiny", "MAX_SLOTS": "1", "PORT": "1"}  # --port wins
    proc = subprocess.Popen(
        [sys.executable, "-m", "devspace_tpu_torch.serve", "--port", str(port),
         "--host", "127.0.0.1", "--device", "cpu"],
        cwd=REPO, env=env, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
    )
    try:
        deadline = time.monotonic() + 60
        while True:
            try:
                code, raw = call(f"http://127.0.0.1:{port}", "/healthz", timeout=2)
                break
            except OSError:
                assert proc.poll() is None, proc.stdout.read().decode()
                assert time.monotonic() < deadline, "server did not come up"
                time.sleep(0.2)
        assert code == 200 and json.loads(raw)["device"] == "cpu"
    finally:
        proc.terminate()
        proc.wait(timeout=10)


# -- the host KV tier and KV migration ----------------------------------------
PROMPT = [(11 * i) % 250 + 3 for i in range(100)]  # one full 64-token block


def test_kv_tier_option_and_env(monkeypatch):
    monkeypatch.delenv("DEVSPACE_KV_TIER", raising=False)
    assert serve.build_engine("tiny", device="cpu", max_slots=1).kv_tier_mode == "off"
    monkeypatch.setenv("DEVSPACE_KV_TIER", "host")
    assert serve.build_engine("tiny", device="cpu", max_slots=1).kv_tier_mode == "host"
    engine = serve.build_engine("tiny", device="cpu", max_slots=1, kv_tier="off")
    assert engine.kv_tier_mode == "off"  # the flag wins


def test_kv_tier_budget_holds_the_pool():
    """The server sizes its tier to hold a payload for every pool block,
    so a max_len chain fits whole; at TINY that is the 256 MiB floor."""
    from devspace_tpu_torch.inference.kv_tier import kv_payload_bytes
    from devspace_tpu_torch.models import transformer as tfm

    cfg = tfm.LLAMA2_7B
    payload = kv_payload_bytes(cfg.n_layers, cfg.n_kv_heads, serve.BLOCK_SIZE, cfg.head_dim)
    assert payload == 17_301_524
    budget = serve.kv_tier_budget(cfg, 8)
    assert budget == 8 * (cfg.max_seq_len // serve.BLOCK_SIZE) * payload
    assert budget // payload >= cfg.max_seq_len // serve.BLOCK_SIZE > (256 << 20) // payload
    assert serve.kv_tier_budget(tfm.TINY, 8) == 256 << 20
    engine = serve.build_engine("tiny", device="cpu", max_slots=1, kv_tier="host")
    assert engine._kv_tier.max_bytes == serve.kv_tier_budget(tfm.TINY, 1)


def test_kv_tier_flag_reaches_healthz():
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        port = s.getsockname()[1]
    env = {**os.environ, "MODEL": "tiny", "MAX_SLOTS": "1", "DEVSPACE_KV_TIER": "off"}
    proc = subprocess.Popen(
        [sys.executable, "-m", "devspace_tpu_torch.serve", "--port", str(port),
         "--host", "127.0.0.1", "--device", "cpu", "--kv-tier", "host"],
        cwd=REPO, env=env, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
    )
    try:
        deadline = time.monotonic() + 60
        while True:
            try:
                code, raw = call(f"http://127.0.0.1:{port}", "/healthz", timeout=2)
                break
            except OSError:
                assert proc.poll() is None, proc.stdout.read().decode()
                assert time.monotonic() < deadline, "server did not come up"
                time.sleep(0.2)
        assert code == 200 and json.loads(raw)["kv_tier"] == "host"
    finally:
        proc.terminate()
        proc.wait(timeout=10)


def test_prefill_and_chain_export(tier_urls, url):
    source = tier_urls[0]
    code, raw = call(source, "/prefill", {"prompt_ids": PROMPT})
    assert code == 200 and json.loads(raw) == {"prefilled_tokens": len(PROMPT)}
    assert call(source, "/prefill", {"max_new_tokens": 3})[0] == 400  # no prompt
    assert call(source, "/prefill", {"prompt_ids": list(range(200))})[0] == 400  # too long
    assert call(source, "/prefill", {"prompt_ids": ["x"]})[0] == 400
    health = json.loads(call(source, "/healthz")[1])
    assert health["kv_tier"] == "host" and health["prefix_cached_blocks"] == 1
    digest = fingerprint_chain(PROMPT, 64)[0]
    code, raw = call(source, f"/kv/chain/{digest}")
    assert code == 200
    assert [d for d, _ in unpack_chain_envelope(raw)] == [digest]
    assert call(source, "/kv/chain/" + "ff" * 16)[0] == 404
    assert call(url, f"/kv/chain/{digest}")[0] == 404  # tier off
    assert json.loads(call(url, "/healthz")[1])["kv_tier"] == "off"


def test_generate_with_kv_source_pulls_the_chain(tier_urls):
    source, cold, decode, orphan = tier_urls
    body = {"prompt_ids": PROMPT, "max_new_tokens": 8}
    assert call(source, "/prefill", {"prompt_ids": PROMPT})[0] == 200
    code, raw = call(cold, "/generate", body)
    assert code == 200
    want = json.loads(raw)["tokens"]
    code, raw = call(decode, "/generate", {**body, "kv_source": source})
    assert code == 200 and json.loads(raw)["tokens"] == want
    health = json.loads(call(decode, "/healthz")[1])
    assert health["kv_migrate_chains"] == 1 and health["kv_migrate_blocks"] == 1
    assert health["kv_restore_hits"] == 1 and health["kv_migrate_failures"] == 0
    assert json.loads(call(source, "/healthz")[1])["kv_export_chains"] >= 1
    # a dead source: the recompute ladder gives the same stream
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        dead = f"http://127.0.0.1:{s.getsockname()[1]}"
    code, raw = call(orphan, "/generate", {**body, "kv_source": dead})
    assert code == 200 and json.loads(raw)["tokens"] == want
    health = json.loads(call(orphan, "/healthz")[1])
    assert health["kv_migrate_failures"] == 1 and health["kv_restore_fallbacks"] == 1
    assert health["kv_migrate_chains"] == 0 and health["kv_tier_remote_nodes"] == 0
