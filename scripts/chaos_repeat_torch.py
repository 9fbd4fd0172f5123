"""The card's chaos scenarios again and again, to look for a rare outcome.

chip_smoke.py's ``chaos`` phase runs (a) kill-mid-stream and (b)
router-kill-prefix-hot once each and stops at the first hung request.
This script builds the kernels, saves the random 7B checkpoint
(seed 0), starts the same two-replica fleet and runs (a) once, then (b)
``DIAG_B_REPEATS`` times (default 3) and (c) disagg-kill-prefill
``DIAG_C_REPEATS`` times (default 0; each repeat after the first with
fresh seeds for its trace and its live migration's prompt, which the
fleet has not cached yet), recording instead of failing:
each wave's outcome counts, the kill's offset in its wave, how long the
victim's port kept accepting connections, every client attempt, every
gateway upstream open and phase-1 prefill with their times, and each
replica's request traces. One JSON line per wave on stdout; everything in the JSON file
``CHAOS_REPEAT_OUT`` names (default ``runs/chaos_repeat.json``). Needs
the card::

    DIAG_B_REPEATS=10 DIAG_C_REPEATS=4 python3 scripts/chaos_repeat_torch.py
"""
import json
import os
import shutil
import sys
import tempfile
import threading
import time
import urllib.request

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
import torch

import chip_smoke as cs
from devspace_tpu_torch.obs import events as obs_events
from devspace_tpu_torch.serving import loadgen as lg
from devspace_tpu_torch.serving import router as rt

OUT = os.environ.get("CHAOS_REPEAT_OUT", os.path.join(cs.REPO_ROOT, "runs", "chaos_repeat.json"))
REPEATS = int(os.environ.get("DIAG_B_REPEATS", "3"))
C_REPEATS = int(os.environ.get("DIAG_C_REPEATS", "0"))
rec = {"waves": [], "events": [], "errors": []}
T0 = time.monotonic()
cur = {}


def now():
    return time.monotonic() - T0


class Sink:
    """Every event of this process, with its time."""

    def record(self, ev):
        d = ev.to_dict()
        d["t_diag"] = now()
        rec["events"].append(d)


obs_events.add_sink(Sink())

_run = lg.LoadGenerator.run


def run(self, trace, speed=1.0):
    cur["t_start"] = now()
    cur.pop("t_kill", None)
    return _run(self, trace, speed)


lg.LoadGenerator.run = run
_kill = cs.ReplicaWatch.kill


def kill(self, name, log=None):
    cur["t_kill"] = now()
    cur["victim"] = name
    url = self.fleet.replica(name).base_url
    cur["probe"] = {"url": url}
    pid = _kill(self, name, log)
    threading.Thread(target=port_probe, args=(url, cur["probe"]), daemon=True).start()
    return pid


cs.ReplicaWatch.kill = kill
_router_init = rt.PrefixRouter.__init__


def router_init(self, *a, **k):
    _router_init(self, *a, **k)
    cur["router"] = self


rt.PrefixRouter.__init__ = router_init
FLEET = {}
TL = []  # per-attempt timelines: client and gateway


_so = lg.LoadGenerator._stream_once


def stream_once(self, url, event, deadline):
    row = {"side": "client", "id": event["id"], "t0": now(), "url": url}
    TL.append(row)
    try:
        out = _so(self, url, event, deadline)
        row.update(t1=now(), tokens=out[0], ttft=out[1])
        return out
    except BaseException as e:
        row.update(t1=now(), error=repr(e)[:200])
        raise


lg.LoadGenerator._stream_once = stream_once
from devspace_tpu_torch.serving import gateway as gwm

_ou = gwm.RoutingGateway._open_upstream


def open_upstream(self, url, body, headers):
    row = {"side": "gateway", "t0": now(), "url": url, "prompt": hash(tuple(json.loads(body)["prompt_ids"]))}
    TL.append(row)
    try:
        r = _ou(self, url, body, headers)
        row.update(t1=now(), status=r.status)
        return r
    except BaseException as e:
        row.update(t1=now(), error=repr(e)[:200])
        raise


gwm.RoutingGateway._open_upstream = open_upstream


def port_probe(url, out):
    """Seconds until a connect to ``url``'s port is refused."""
    import socket
    port = int(url.rsplit(":", 1)[1])
    t = time.monotonic()
    while time.monotonic() - t < 60:
        try:
            socket.create_connection(("127.0.0.1", port), timeout=1).close()
        except OSError as e:
            out["refused_after_s"] = time.monotonic() - t
            out["err"] = repr(e)
            return
        time.sleep(0.005)
    out["refused_after_s"] = None


def debug(url, path):
    try:
        with urllib.request.urlopen(url + path, timeout=10) as r:
            return json.loads(r.read())
    except Exception as e:  # noqa: BLE001
        return {"error": str(e)}


def held(scenario, report, trace, table, corrupted, log=None, fleet=None):
    """chip_smoke.held, recording the wave instead of failing on it."""
    by_id = {e["id"]: e for e in trace}
    outs = []
    for o in report.outcomes:
        e = by_id[o.id]
        outs.append({"id": o.id, "outcome": o.outcome, "attempts": o.attempts,
                     "latency_s": o.latency_s, "ttft_s": o.ttft_s, "at": e["at"],
                     "prompt_len": len(e["prompt_ids"]), "n": e["max_new_tokens"],
                     "session": e.get("session"), "error": o.error[:200]})
    time.sleep(1.0)
    fleet = FLEET["fleet"]
    reqs = {}
    for name, url in fleet.targets().items():
        reqs[name] = {"requests": debug(url, "/debug/requests?limit=400"),
                      "events": debug(url, "/debug/events?limit=300"),
                      "healthz": debug(url, "/healthz")}
    router = cur.get("router")
    hashes = {hash(tuple(e["prompt_ids"])): e["id"] for e in trace}
    t_start = cur.get("t_start") or 0
    tl = [dict(r, id=r.get("id", hashes.get(r.get("prompt")))) for r in TL
          if r["t0"] >= t_start - 0.01]
    TL.clear()
    wave = {"timeline": tl, "probe": dict(cur.get("probe") or {}),
            "scenario": scenario, "t_start": cur.get("t_start"), "t_kill": cur.get("t_kill"),
            "victim": cur.get("victim"), "counts": report.counts(), "outcomes": outs,
            "attempt_log": list(log.rows) if log is not None else None,
            "replicas": reqs,
            "router": router.stats() if router is not None else None}
    rec["waves"].append(wave)
    bad = [o for o in outs if o["outcome"] in ("hung", "failed")]
    tk = cur.get("t_kill")
    rel = None if tk is None else tk - cur["t_start"]
    if bad:
        for o in bad:
            print("BAD TIMELINE", o["id"], json.dumps([r for r in tl if r.get("id") == o["id"]]), flush=True)
    print(json.dumps({"scenario": scenario, "counts": report.counts(), "kill_at": rel,
                      "probe": cur.get("probe"), "slowest_gateway_open": max(
                          [r.get("t1", 1e9) - r["t0"] for r in tl if r["side"] == "gateway"] or [0]),
                      "max_ttft": max(o["ttft_s"] for o in outs),
                      "ttft_sorted_top": sorted((round(o["ttft_s"], 3) for o in outs))[-5:],
                      "bad": bad}), flush=True)
    with open(OUT, "w") as f:
        json.dump(rec, f, default=str)
    for o in report.outcomes:
        if o.outcome == "corrupted":
            corrupted.append({"scenario": scenario, "id": o.id})
    return {**report.to_dict(), "failed_or_hung": bad}


cs.held = held


def main():
    os.makedirs(os.path.dirname(os.path.abspath(OUT)), exist_ok=True)
    dev = torch.device("cuda", 0)
    torch.cuda.set_device(dev)
    print(cs.card_line(), flush=True)
    cs._build.build(*cs.SOURCES)
    ckpt = tempfile.mkdtemp(prefix="llama2-7b-")
    try:
        params = cs.tfm.init_params(cs.tfm.LLAMA2_7B, torch.Generator(device=dev).manual_seed(0))
        cs.save_checkpoint(os.path.join(ckpt, "step_00000001"), params)
        del params
        torch.cuda.empty_cache()
        print("ckpt saved", now(), flush=True)
        from devspace_tpu_torch.serving import ReplicaFleet
        fleet = ReplicaFleet(spec=cs.replica_spec(ckpt, "llama2-7b", **cs.FLEET_SLO_ENV,
                                                  **cs.CHAOS_ENV), replicas=2, poll_interval=1.0)
        FLEET["fleet"] = fleet
        watch = cs.ReplicaWatch(fleet)
        corrupted = []
        c_runs = 0
        try:
            fleet.start()
            print("fleet up", now(), flush=True)
            watch.seen()
            for key, fn in [("a", cs.chaos_kill_mid_stream)] + [
                    ("b", cs.chaos_router_kill_prefix_hot)] * REPEATS + [
                    ("c", cs.chaos_disagg_kill_prefill)] * C_REPEATS:
                if key == "c" and c_runs:
                    cs.CHAOS_LIVE_SEED += 1
                    cs.CHAOS["disagg_kill_prefill"]["trace"]["seed"] += 100
                c_runs += key == "c"
                try:
                    out = fn(fleet, watch, cs.tfm.LLAMA2_7B, corrupted)
                    print(key, "ok", now(), json.dumps({k: v for k, v in out.items()
                                                         if k.startswith("p99")}), flush=True)
                except AssertionError as e:
                    rec["errors"].append(f"{key}: {e!r}")
                    print(key, "ASSERT", repr(e)[:500], flush=True)
                    cs.wait_until(fleet.all_healthy, 600, "healthy")
                    watch.seen()
        finally:
            fleet.stop()
    finally:
        shutil.rmtree(ckpt, ignore_errors=True)
        with open(OUT, "w") as f:
            json.dump(rec, f, default=str)
        rec["watch_rows"] = {k: {f: v.get(f) for f in ("killed", "dead_after_s")}
                             for k, v in watch.rows.items()}
        with open(OUT, "w") as f:
            json.dump(rec, f, default=str)
    print("done", now(), json.dumps(rec.get("watch_rows")), flush=True)


if __name__ == "__main__":
    main()
