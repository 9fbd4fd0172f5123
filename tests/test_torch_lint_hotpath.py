"""The port's hot-path rules (devspace_tpu_torch/lint/rules_hotpath.py,
JIT500-504 over torch) and its analysis gate
(scripts/analysis_gate_torch.py).

- Each seeded fixture under tests/fixtures/analysis_torch/ trips exactly
  the ids of its ``# expect:`` header.
- Each rule on small sources: what it flags and what it leaves alone.
- A ``lint: allow(...)`` pragma by full id or family prefix suppresses
  its finding.
- The self-lint of the port, its scripts and chip_smoke.py is at zero
  outside scripts/analysis_baseline_torch.json, and the gate's static
  legs exit 0.
"""

import json
import os
import re
import subprocess
import sys

import pytest

from devspace_tpu_torch.lint import lint_python_sources

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
FIXTURES = os.path.join(REPO, "tests", "fixtures", "analysis_torch")
sys.path.insert(0, os.path.join(REPO, "scripts"))
import analysis_gate_torch as gate  # noqa: E402


def run(src: str) -> list:
    return sorted((f.rule_id, f.line) for f in lint_python_sources([("mod.py", src)]))


@pytest.mark.parametrize("name", sorted(n for n in os.listdir(FIXTURES) if n.endswith(".py")))
def test_fixture_trips_exactly_its_expected_ids(name):
    with open(os.path.join(FIXTURES, name)) as fh:
        text = fh.read()
    expected = set(re.search(r"#\s*expect:\s*([A-Z0-9 ,]+)", text).group(1)
                   .replace(",", " ").split())
    found = {f.rule_id for f in lint_python_sources([(name, text)])}
    assert found == expected


CAPTURE = """import torch
def f(step, x, n, chunks):
{body}
"""


@pytest.mark.parametrize("body, want", [
    # JIT500: graphs, captures, compiled callables, tables built in a loop
    ("    for _ in range(n):\n        g = torch.cuda.CUDAGraph()\n", [("JIT500", 4)]),
    ("    while n:\n        t = ProgramTable(x, x)\n        n -= 1\n", [("JIT500", 4)]),
    ("    for c in chunks:\n        s = torch.compile(step)\n", [("JIT500", 4)]),
    ("    g = torch.cuda.CUDAGraph()\n    with torch.cuda.graph(g):\n        step(x)\n", []),
    # JIT501: loop-varying ints into captured or compiled code
    ("    g = torch.cuda.CUDAGraph()\n    with torch.cuda.graph(g):\n"
     "        for i in range(n):\n            step(x, i)\n", [("JIT501", 6)]),
    ("    off = 0\n    for c in chunks:\n        with torch.cuda.graph(c):\n"
     "            step(x, offset=off * 2)\n        off += 1\n",
     [("JIT501", 6)]),
    ("    for i, c in enumerate(chunks):\n        with torch.cuda.graph(c):\n"
     "            step(x, 4)\n", []),
    ("    for i in range(n):\n        step(x, i)\n", []),  # eager: nothing baked
    # JIT502: host syncs in a loop
    ("    for c in chunks:\n        a = c.item()\n        b = c.tolist()\n", [("JIT502", 4),
                                                                          ("JIT502", 5)]),
    ("    for c in chunks:\n        v = c.cpu().numpy()\n", [("JIT502", 4)]),
    ("    for c in chunks:\n        torch.cuda.synchronize()\n        ev.synchronize()\n",
     [("JIT502", 4), ("JIT502", 5)]),
    ("    for c in chunks:\n        s = torch.sum(c)\n        if float(s) > 0:\n            pass\n"
     "        k = int(n)\n", [("JIT502", 5)]),
    ("    v = x.item()\n    return x.tolist()\n", []),
    ("    for c in chunks:\n        c.item(0)\n        c.cpu(1)\n", []),
    # JIT503: a replayed graph's static output kept without a clone
    ("    outs = []\n    for _ in range(n):\n        x.replay()\n        outs.append(step)\n",
     [("JIT503", 6)]),
    ("    outs = []\n    for _ in range(n):\n        x.replay()\n"
     "        outs.append(step.clone())\n", []),
    ("    outs = {}\n    for c in chunks:\n        x.replay()\n        t = step.sum()\n"
     "        outs[c] = t\n", []),  # a fresh value each iteration
    ("    x.replay()\n    first = step\n    x.replay()\n    return first\n", [("JIT503", 4)]),
    ("    x.replay()\n    first = step\n    return first\n", []),
    ("    x.replay()\n    first = step\n    first = step.clone()\n    x.replay()\n"
     "    return first\n", []),
    # JIT504: slices with moving bounds into captured or compiled code
    ("    for i in range(n):\n        with torch.cuda.graph(chunks):\n"
     "            step(x[i:i + 4])\n", [("JIT504", 5)]),
    ("    for i in range(n):\n        with torch.cuda.graph(chunks):\n"
     "            step(x[0:4])\n", []),
])
def test_rule_cases(body, want):
    src = CAPTURE.format(body=body)
    got = run(src)
    # JIT500 also fires on a capture context inside a loop: count only the
    # rules the case is about
    about = {r for r, _ in want} or {"JIT501", "JIT502", "JIT503", "JIT504"}
    if not want and "torch.cuda.graph" not in body:
        about |= {"JIT500"}
    assert [g for g in got if g[0] in about] == want, got


def test_compiled_callables_and_tables_are_recognised():
    src = (
        "import torch\n"
        "@torch.compile\n"
        "def fwd(x, n):\n"
        "    return x * n\n"
        "class E:\n"
        "    def __init__(self):\n"
        "        self._programs = ProgramTable(0, 0)\n"
        "        self._step = torch.compile(fwd)\n"
        "    def go(self, x, chunks, n):\n"
        "        off = 0\n"
        "        for c in chunks:\n"
        "            fwd(x, off)\n"
        "            self._step(x[off:n], 1)\n"
        "            self._programs.run(c)\n"
        "            self.keep.append(self.out)\n"
        "            off += 1\n"
    )
    assert run(src) == [("JIT501", 12), ("JIT503", 15), ("JIT504", 13)]


def test_pragma_suppresses_by_id_and_family():
    base = "def f(chunks):\n    for c in chunks:\n        c.item(){}\n"
    assert run(base.format("")) == [("JIT502", 3)]
    assert run(base.format("  # lint: allow(JIT502) — the readback is the product")) == []
    assert run(base.format("  # lint: allow(JIT)")) == []
    assert run(base.format("  # lint: allow(CON601)")) == [("JIT502", 3)]


def test_self_lint_is_clean_outside_the_baseline():
    problems, counts = gate.self_lint()
    assert problems == [] and counts["outside_baseline"] == 0
    assert counts["files"] > 70
    with open(gate.BASELINE_PATH) as fh:
        assert json.load(fh) == []  # nothing is carried as known debt
    # the engine's designed readbacks carry their pragma
    with open(os.path.join(REPO, "devspace_tpu_torch", "inference", "speculative.py")) as fh:
        assert "lint: allow(JIT502)" in fh.read()


def test_gate_static_legs_pass():
    proc = subprocess.run([sys.executable, os.path.join(REPO, "scripts",
                                                        "analysis_gate_torch.py"),
                           "--skip-serving"], capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stdout + proc.stderr
    assert "[gate] ok" in proc.stdout and "0 missed" in proc.stdout
    assert "0 above baseline" in proc.stdout
