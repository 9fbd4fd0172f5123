#!/usr/bin/env python
"""CI gate for the port's analyzers (``devspace_tpu_torch.lint``): static
and runtime.

Four legs, all of which must pass for exit 0:

1. **Self-lint** — the AST packs (PY500/JIT5xx/CON6xx) over
   ``devspace_tpu_torch/``, ``scripts/*_torch.py`` and ``chip_smoke.py``.
   Any finding not in ``scripts/analysis_baseline_torch.json`` fails the
   gate (warnings too; designed sync points carry ``lint: allow(...)``
   pragmas instead of baseline entries). SARIF goes to ``--output``.
2. **Catalog lint** — OBS7xx over the port's metric, event and timeline
   catalogs.
3. **Fixture detection** — every seeded bug under
   ``tests/fixtures/analysis_torch/`` trips exactly the rule ids its
   ``# expect:`` header declares, and every concurrency fixture (CON) of
   ``tests/fixtures/analysis/`` trips its ids under the port's pack.
4. **Capture tripwire** — a TINY CPU engine runs a warm wave, then an
   identical wave under ``CompileWatch``: a program built after the
   warm-up (a graph capture on the card) fails the gate, and the watch's
   count must equal the engine's ``graph_captures`` delta.
   ``--skip-serving`` skips this leg.

Usage: python scripts/analysis_gate_torch.py [--output gate.sarif]
       [--skip-serving] [--text]
"""

from __future__ import annotations

import argparse
import json
import os
import re
import sys

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)

_EXPECT_RE = re.compile(r"#\s*expect:\s*([A-Z0-9 ,]+)")

BASELINE_PATH = os.path.join(REPO, "scripts", "analysis_baseline_torch.json")
FIXTURE_DIR = os.path.join(REPO, "tests", "fixtures", "analysis_torch")
# the reference's fixtures, read and never edited: its concurrency ones
# hold the port's copy of the CON pack too
CONCURRENCY_FIXTURE_DIR = os.path.join(REPO, "tests", "fixtures", "analysis")


def _load_baseline() -> set:
    """Finding keys (``RULEID artifact:line``) accepted as known debt.
    Absent file == empty baseline."""
    if not os.path.exists(BASELINE_PATH):
        return set()
    with open(BASELINE_PATH, encoding="utf-8") as fh:
        return set(json.load(fh))


def finding_key(f) -> str:
    return f"{f.rule_id} {f.artifact}:{f.line}"


def self_lint_sources() -> list:
    """``[(relpath, text)]`` the self-lint covers: the port, its scripts
    and the card's smoke script."""
    from devspace_tpu_torch.lint import collect_python_sources

    sources = collect_python_sources(REPO, ("devspace_tpu_torch",))
    extra = ["chip_smoke.py"] + sorted(
        os.path.join("scripts", n)
        for n in os.listdir(os.path.join(REPO, "scripts")) if n.endswith("_torch.py"))
    for rel in extra:
        with open(os.path.join(REPO, rel), encoding="utf-8", errors="replace") as fh:
            sources.append((rel, fh.read()))
    return sorted(sources)


def self_lint(output: str = "", text: bool = False) -> tuple[list, dict]:
    """Problems (findings outside the baseline) and the leg's counts."""
    from devspace_tpu_torch.lint import lint_python_sources
    from devspace_tpu_torch.lint.reporters import to_sarif_json, to_text

    sources = self_lint_sources()
    findings = lint_python_sources(sources)
    if output:
        with open(output, "w", encoding="utf-8") as fh:
            fh.write(to_sarif_json(findings) + "\n")
    if text and findings:
        print(to_text(findings))
    baseline = _load_baseline()
    problems = [
        f"self-lint: {finding_key(f)}{f' [{f.location}]' if f.location else ''}: {f.message}"
        for f in findings if finding_key(f) not in baseline
    ]
    print(f"[gate] self-lint: {len(sources)} files, {len(findings)} finding(s), "
          f"{len(problems)} above baseline")
    return problems, {"files": len(sources), "findings": len(findings),
                      "outside_baseline": len(problems)}


def catalog_lint() -> list:
    from devspace_tpu_torch.lint import lint_obs_catalogs

    findings = lint_obs_catalogs()
    print(f"[gate] catalogs: {len(findings)} finding(s)")
    return [f"catalogs: {f.rule_id} {f.location}: {f.message}" for f in findings]


def _expected(text: str) -> set:
    m = _EXPECT_RE.search(text)
    return set(m.group(1).replace(",", " ").split()) if m else set()


def fixture_detection() -> list:
    """Each torch fixture trips exactly its ``# expect:`` ids; each
    reference concurrency fixture at least its ids."""
    from devspace_tpu_torch.lint import lint_python_sources

    cases = []
    for d, exact in ((FIXTURE_DIR, True), (CONCURRENCY_FIXTURE_DIR, False)):
        for name in sorted(n for n in os.listdir(d) if n.endswith(".py")):
            with open(os.path.join(d, name), encoding="utf-8") as fh:
                text = fh.read()
            expected = _expected(text)
            if not exact and not all(r.startswith("CON") for r in expected):
                continue
            cases.append((os.path.relpath(os.path.join(d, name), REPO), text, expected, exact))
    problems = []
    for rel, text, expected, exact in cases:
        if not expected:
            problems.append(f"fixtures: {rel} has no '# expect:' header")
            continue
        found = {f.rule_id for f in lint_python_sources([(rel, text)])}
        if (found != expected) if exact else not expected <= found:
            problems.append(f"fixtures: {rel} expected {sorted(expected)}, found "
                            f"{sorted(found) or 'none'}")
    print(f"[gate] fixtures: {len(cases)} seeded bug(s), {len(problems)} missed")
    return problems


def serving_tripwire() -> list:
    """Warm a TINY CPU engine, then rerun the identical wave under
    CompileWatch: the dynamic half of JIT500/501."""
    import numpy as np
    import torch

    from devspace_tpu_torch.inference import InferenceEngine
    from devspace_tpu_torch.lint.runtime import CompileWatch
    from devspace_tpu_torch.models import transformer as tfm

    params = tfm.init_params(tfm.TINY, torch.Generator().manual_seed(0))
    rng = np.random.default_rng(0)
    prompts = [rng.integers(1, tfm.TINY.vocab_size, size=int(rng.integers(4, 24))).tolist()
               for _ in range(2)]
    engine = InferenceEngine(params, tfm.TINY, device="cpu", max_slots=2, max_len=64,
                             chunk_max=4, block_size=16).start()
    try:
        # warm-up: one request alone decodes its 7 steps as chunks of 4, 2
        # and 1 (every greedy program), then the wave
        for wave in (prompts[:1], prompts):
            for h in [engine.submit(p, 8) for p in wave]:
                h.result(timeout=300)
        before = engine.stats()["graph_captures"]
        with CompileWatch("gate-serving") as watch:
            for h in [engine.submit(p, 8) for p in prompts]:
                h.result(timeout=300)
        delta = engine.stats()["graph_captures"] - before
    finally:
        engine.stop()
    print(f"[gate] serving tripwire: {watch.count} capture(s) after warm-up "
          f"(graph_captures delta {delta})")
    if watch.count or delta:
        return [f"serving: {watch.count} program build(s) after warm-up (graph_captures "
                f"delta {delta}) — a program key reached serving that the warm wave did "
                "not build"]
    return []


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--output", help="write the self-lint SARIF here")
    ap.add_argument("--text", action="store_true", help="also print self-lint findings as text")
    ap.add_argument("--skip-serving", action="store_true",
                    help="skip the CompileWatch serving leg (static checks only)")
    args = ap.parse_args()

    problems, _ = self_lint(args.output, args.text)
    problems += catalog_lint()
    problems += fixture_detection()
    if args.skip_serving:
        print("[gate] serving tripwire: skipped (--skip-serving)")
    else:
        problems += serving_tripwire()
    for p in problems:
        print(f"ERROR {p}")
    if problems:
        print(f"[gate] FAIL: {len(problems)} problem(s)")
        return 1
    print("[gate] ok")
    return 0


if __name__ == "__main__":
    sys.exit(main())
