"""Determinism gate for the port's chaos suite.

Runs every `chaos`-marked test of the port's test files
(`tests/test_torch_*.py`) 3 times under a fixed seed env and fails if any
test's outcome (pass/fail/error/skip) differs between repeats. The port's
copy of `scripts/chaos_check.py`: the same seed, the same outcome
parsing, the same exit codes; it imports nothing of the JAX package (the
tests it runs compare the port with it).

Usage:
    python scripts/chaos_check_torch.py [--repeats N] [-- <extra pytest args>]

Exit codes: 0 all repeats identical (and passing), 1 outcome drift or
test failures, 2 harness error.
"""

import argparse
import glob
import json
import os
import subprocess
import sys
import tempfile

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CHAOS_SEED = "0"  # fixed: policies under test derive jitter from seed=0

# Modules that MUST contribute chaos-marked tests for the gate to mean
# anything: a renamed marker or module would otherwise silently shrink the
# suite to zero relevant tests while the gate stays green.
REQUIRED_CHAOS_MODULES = (
    # the overlapped serving loop's failure ladder: a mid-window decode
    # fault fails every in-flight chunk and rebuilds the pool
    "test_torch_dispatch",
    # KV-block migration: a dead source and a corrupted chain envelope
    # both end in recompute-prefill with matching failure/fallback counters
    "test_torch_kv_migrate",
    # the host KV tier's degradation ladder: a restore failure falls back
    # to recompute, a corrupted payload is dropped on digest mismatch
    "test_torch_kv_tier_engine",
    # the serving tier under SIGKILL: a routed replica killed mid-stream
    # reroutes with zero corrupted outcomes, a prefill-pool replica killed
    # mid-migration degrades every orphaned migration cleanly
    "test_torch_serving_chaos",
)


def chaos_test_files() -> list[str]:
    """The port's test files, relative to the repo root."""
    return sorted(os.path.relpath(p, REPO)
                  for p in glob.glob(os.path.join(REPO, "tests", "test_torch_*.py")))


def run_chaos_suite(run_idx: int, extra_args: list[str]) -> dict[str, str]:
    """One pytest pass over the chaos marker; returns {test_id: outcome}."""
    report = os.path.join(
        tempfile.gettempdir(), f"chaos_torch_report_{os.getpid()}_{run_idx}.jsonl"
    )
    env = dict(os.environ)
    env["JAX_PLATFORMS"] = "cpu"  # the tests run the JAX reference beside the port
    env["DEVSPACE_CHAOS_SEED"] = CHAOS_SEED
    cmd = [
        sys.executable,
        "-m",
        "pytest",
        *chaos_test_files(),
        "-q",
        "-m",
        "chaos",
        "-p",
        "no:cacheprovider",
        "-p",
        "no:randomly",
        "--tb=line",
        f"--junitxml={report}.xml",
        *extra_args,
    ]
    proc = subprocess.run(cmd, cwd=REPO, env=env, capture_output=True, text=True)
    outcomes = parse_junit(f"{report}.xml")
    if not outcomes:
        print(proc.stdout[-2000:], file=sys.stderr)
        print(proc.stderr[-2000:], file=sys.stderr)
        raise RuntimeError(f"run {run_idx}: no chaos tests collected")
    try:
        os.unlink(f"{report}.xml")
    except OSError:
        pass
    return outcomes


def parse_junit(path: str) -> dict[str, str]:
    import xml.etree.ElementTree as ET

    try:
        root = ET.parse(path).getroot()
    except (OSError, ET.ParseError):
        return {}
    out: dict[str, str] = {}
    for case in root.iter("testcase"):
        tid = f"{case.get('classname')}::{case.get('name')}"
        if case.find("failure") is not None:
            out[tid] = "failed"
        elif case.find("error") is not None:
            out[tid] = "error"
        elif case.find("skipped") is not None:
            out[tid] = "skipped"
        else:
            out[tid] = "passed"
    return out


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--repeats", type=int, default=3)
    ap.add_argument("pytest_args", nargs="*", help="extra pytest args after --")
    args = ap.parse_args()

    runs: list[dict[str, str]] = []
    for i in range(args.repeats):
        print(f"[chaos-check-torch] repeat {i + 1}/{args.repeats} ...", flush=True)
        try:
            runs.append(run_chaos_suite(i, args.pytest_args))
        except RuntimeError as e:
            print(f"[chaos-check-torch] {e}", file=sys.stderr)
            return 2

    baseline = runs[0]
    missing = [
        mod
        for mod in REQUIRED_CHAOS_MODULES
        if not any(mod in tid for tid in baseline)
    ]
    if missing:
        print(
            f"[chaos-check-torch] FAIL: no chaos tests collected from: {', '.join(missing)}"
            " (marker or module renamed? the gate must cover these suites)",
            file=sys.stderr,
        )
        return 1

    drift = False
    for i, run in enumerate(runs[1:], start=2):
        all_ids = sorted(set(baseline) | set(run))
        for tid in all_ids:
            a, b = baseline.get(tid, "<absent>"), run.get(tid, "<absent>")
            if a != b:
                drift = True
                print(
                    f"[chaos-check-torch] DRIFT {tid}: run 1 ={a}, run {i} ={b}",
                    file=sys.stderr,
                )
    failures = sorted(t for t, o in baseline.items() if o in ("failed", "error"))

    summary = {
        "repeats": args.repeats,
        "tests": len(baseline),
        "deterministic": not drift,
        "failures": failures,
    }
    print(json.dumps(summary))
    if drift:
        print("[chaos-check-torch] FAIL: nondeterministic outcomes", file=sys.stderr)
        return 1
    if failures:
        print(
            f"[chaos-check-torch] FAIL: {len(failures)} test(s) failed (deterministically)",
            file=sys.stderr,
        )
        return 1
    print(
        f"[chaos-check-torch] OK: {len(baseline)} chaos tests x {args.repeats} "
        "repeats, identical outcomes"
    )
    return 0


if __name__ == "__main__":
    sys.exit(main())
