"""A CPU rehearsal of chip_smoke.py's ``chaos`` phase at TINY: two torch
replicas of a saved TINY checkpoint (``--device cpu``, the host KV tier)
run the three scenarios with shorter traces scaled to TINY's 128
positions (and the live migration before the third on an 80-token
prompt), and the line carries its keys with their types. The phase
itself runs on the card (``python3 chip_smoke.py``)."""

import dataclasses
import json

import torch

import chip_smoke as cs

# the scenarios' traffic cut to TINY: prompt plus new tokens within 128
# positions, 16-token router blocks, traces of 1-1.5 s
TINY_CHAOS = {
    "kill_mid_stream": {
        **cs.CHAOS["kill_mid_stream"],
        "trace": {"seed": 11, "kind": "poisson", "duration_s": 1.5, "rate_rps": 8,
                  "max_new_tokens": (48, 64)}},
    "router_kill_prefix_hot": {
        **cs.CHAOS["router_kill_prefix_hot"], "block_size": 16,
        "trace": {"kind": "chat", "duration_s": 1.0, "rate_rps": 4, "turns": (2, 2),
                  "max_new_tokens": (8, 12), "prompt_len": (16, 32)}},
    "disagg_kill_prefill": {
        **cs.CHAOS["disagg_kill_prefill"], "block_size": 16,
        "trace": {"seed": 31, "kind": "rag", "duration_s": 1.5, "rate_rps": 6,
                  "rag_contexts": 2, "rag_context_len": (64, 80), "rag_long_fraction": 0.5,
                  "max_new_tokens": (8, 12)}},
    "in_flight": 8,
}


def test_chaos_phase_rehearsed_on_the_cpu(monkeypatch, tmp_path):
    from devspace_tpu_torch.models import transformer as tfm
    from devspace_tpu_torch.serving import ReplicaSpec
    from devspace_tpu_torch.training.checkpoint import save_checkpoint

    @dataclasses.dataclass
    class CpuSpec(ReplicaSpec):
        def command(self, port):
            return super().command(port) + ["--device", "cpu"]

    real_spec = cs.replica_spec

    def cpu_spec(ckpt_dir, model, **env):
        spec = real_spec(ckpt_dir, model, SPEC="0", **env)  # tiny drafts for itself
        return CpuSpec(**{f.name: getattr(spec, f.name) for f in dataclasses.fields(spec)})

    monkeypatch.setattr(cs, "replica_spec", cpu_spec)
    monkeypatch.setattr(cs, "CHAOS", TINY_CHAOS)
    monkeypatch.setattr(cs, "CHAOS_LIVE_TOKENS", 80)  # one 64-token engine block
    monkeypatch.setattr(cs, "CHAOS_LIVE_NEW", 8)
    monkeypatch.setattr(cs, "FLEET", {**cs.FLEET, "ready_timeout_s": 120.0})
    ckpt = str(tmp_path / "tiny")
    save_checkpoint(ckpt, tfm.init_params(tfm.TINY, torch.Generator().manual_seed(0)))
    line = cs.phase_chaos(ckpt, "cpu", 1.0, torch.device("cpu"), model="tiny", cfg=tfm.TINY)

    assert line["phase"] == "chaos" and line["env"]["DEVSPACE_KV_TIER"] == "host"
    assert [c["field"] for c in line["changed"]] == ["prompt_len", "rag_context_len"]
    a, b, c = (line[k] for k in ("kill_mid_stream", "router_kill_prefix_hot",
                                 "disagg_kill_prefill"))
    for report in [a["report"], c["report"]] + [w["report"] for w in b["waves"].values()]:
        assert sum(report["counts"].values()) == report["requests"] > 0
        assert report["counts"]["hung"] == 0
        for key in ("p50_latency_s", "p95_latency_s", "p50_ttft_s", "p99_ttft_s", "wall_s"):
            assert isinstance(report[key], float)
    assert a["victim"] == "replica-0" and a["report"]["counts"]["retried"] >= 1
    assert sorted(b["waves"]) == ["21", "22", "23"] and "victim" in b["waves"]["22"]
    assert b["p99_ttft_recovered_s"] <= b["p99_ttft_bound_s"]
    assert c["victim"] == "replica-1" and c["report"]["counts"]["failed"] == 0
    assert c["prefill_dispatches"] >= 1
    assert c["migrate_failures"] == c["recompute_fallbacks"]
    live = c["live_migration"]
    assert live["prefill_replica"] == "replica-1" and live["decode_replica"] == "replica-0"
    assert live["kv_migrate_chains"] >= 1 and live["kv_migrate_bytes"] > 0
    assert live["kv_migrate_failures"] == 0 and live["export_chains"] >= 1
    for scenario in (a, b["waves"]["22"], c):
        assert 0 < scenario["all_healthy_after_s"] < 120
    # the pair, one restart a scenario: five processes seen
    assert len(line["replicas_seen"]) == 5
    assert sum(row["killed"] for row in line["replicas_seen"].values()) == 3
    for row in line["replicas_seen"].values():
        assert row["graph_captures_ready"] == row["graph_captures_last"] > 0
    assert line["paged_decode_launches"] == 0  # counted on the card only
    assert line["near_tie_count"] == len(line["near_ties"])
    json.dumps(line)  # one JSON line
