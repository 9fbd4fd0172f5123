"""A CPU rehearsal of chip_smoke.py's ``operate`` phase: the port's CLI
starts ``fleet serve`` as a child with the stub replicas
(``devspace_tpu_torch.serving.stub``: replicas get no ``--device`` from
``fleet serve``, and the server refuses to run without CUDA), and the
single-server commands (``status serving``, ``profile serving``, ``top``)
go to a TINY ``python -m devspace_tpu_torch.serve --device cpu`` this test
starts, since the stub serves no ``/debug/trace`` or ``/debug/requests``.
The phase's whole control flow and checks run; only the kernel-launch and
graph-capture checks, which only the card can show, are left out by the
phase itself. Its own file, so that ``--dist loadfile`` puts it beside,
not behind, the other rehearsals."""

import json
import os
import subprocess
import sys
import time
import urllib.request

import pytest
import torch

import chip_smoke as cs
from devspace_tpu_torch.models import transformer as tfm
from devspace_tpu_torch.serving.fleet import free_port

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.fixture
def tiny_server():
    port = free_port()
    # short decode chunks, so a capture of a few seconds holds whole ones
    env = dict(os.environ, PYTHONPATH=REPO, MODEL="tiny", MAX_SLOTS="2", SPEC="0",
               CHUNK_MAX="2")
    proc = subprocess.Popen(
        [sys.executable, "-m", "devspace_tpu_torch.serve", "--device", "cpu", "--port",
         str(port), "--host", "127.0.0.1"],
        cwd=REPO, env=env, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
    url = f"http://127.0.0.1:{port}"
    try:
        deadline = time.monotonic() + 120
        while True:
            assert proc.poll() is None, proc.stdout.read()[-2000:]
            try:
                with urllib.request.urlopen(url + "/healthz", timeout=2):
                    break
            except OSError:
                assert time.monotonic() < deadline, "the TINY server never answered"
                time.sleep(0.2)
        yield url
    finally:
        proc.terminate()
        try:
            proc.wait(timeout=10)
        except subprocess.TimeoutExpired:
            proc.kill()
            proc.wait()


def test_operate_phase_rehearsed_on_the_cpu(tiny_server, tmp_path, monkeypatch):
    # TINY decodes bf16 on the CPU: short requests through a longer capture
    monkeypatch.setitem(cs.OPERATE, "profile_new_tokens", 8)
    monkeypatch.setitem(cs.OPERATE, "profile_s", 4.0)
    line = cs.phase_operate(str(tmp_path), "cpu", 0.0, torch.device("cpu"), model="tiny",
                            cfg=tfm.TINY, module="devspace_tpu_torch.serving.stub",
                            replica_target=tiny_server)
    n = cs.OPERATE["requests"]
    assert line["tokens_received"] == n * cs.OPERATE["new_tokens"]
    # the stub counts requests, and keeps no request traces: every stream
    # is held to every replica's direct answer
    assert line["federated"] == {"engine_requests_completed_total": n}
    assert line["served_by"] == {} and line["streams_equal_direct"] is True
    assert line["near_ties"] == [] and line["paged_decode_launches"] == 0
    assert [c["args"][:2] for c in line["cli"]] == [
        ["fleet", "status"], ["top", "--url"], ["top", "--fleet"], ["profile", "serving"],
        ["status", "serving"], ["debug", "bundle"], ["collector", "serve"]]
    assert all(c["rc"] == 0 for c in line["cli"])
    assert line["profile"]["spans"] > 0 and line["profile"]["tokens_decoded"] > 0
    assert line["status_serving_tokens"] >= line["profile"]["tokens_decoded"]
    # manifest, fleet.json, fleet_metrics.txt, fleet_trace.json and six
    # members per replica (the stub answers three of them)
    assert line["bundle_members"] >= 4 + 2 * 3
    assert line["stop_rc"] == 0 and line["replicas_left"] == []
    assert "restart" not in line["fleet_stopped"]
    assert 0 < line["up_s"] < cs.OPERATE["up_timeout_s"]
    json.dumps(line)
