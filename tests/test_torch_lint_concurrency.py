"""The port's copy of the CON6xx pack (devspace_tpu_torch/lint/
rules_concurrency.py) against the JAX package's: on every concurrency
fixture, on every module of the JAX package and of the port read as
text, CON600-604 give equal (rule_id, artifact, line, message) and
``extract_lock_graph`` gives an equal graph. The port's own modules lint
clean under it."""

import dataclasses
import os

import pytest

from devspace_tpu.lint import collect_python_sources as jcollect
from devspace_tpu.lint import extract_lock_graph as jgraph
from devspace_tpu.lint import lint_python_sources as jlint
from devspace_tpu_torch.lint import collect_python_sources as tcollect
from devspace_tpu_torch.lint import extract_lock_graph as tgraph
from devspace_tpu_torch.lint import lint_python_sources as tlint

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
FIXTURES = os.path.join(REPO, "tests", "fixtures", "analysis")
FIXTURE_NAMES = sorted(n for n in os.listdir(FIXTURES) if n.endswith(".py"))


def con_keys(findings) -> list:
    return sorted((f.rule_id, f.artifact, f.line, f.message, f.location) for f in findings)


def assert_same(sources):
    j = jlint(sources, categories={"concurrency"})
    t = tlint(sources, categories={"concurrency"})
    assert con_keys(t) == con_keys(j)
    for path, text in sources:
        a, b = jgraph(path, text), tgraph(path, text)
        assert (a is None) == (b is None), path
        if a is not None:
            assert dataclasses.asdict(a) == dataclasses.asdict(b), path
            assert a.cycles() == b.cycles(), path
    return t


@pytest.mark.parametrize("name", FIXTURE_NAMES)
def test_fixture_findings_and_graph_equal_the_reference(name):
    with open(os.path.join(FIXTURES, name)) as fh:
        text = fh.read()
    found = assert_same([(f"tests/fixtures/analysis/{name}", text)])
    head = text.splitlines()[0]
    if "expect: CON" in head:
        assert {f.rule_id for f in found} == set(head.split(":", 1)[1].replace(",", " ").split())


def test_every_reference_module_equal():
    sources = jcollect(REPO, ("devspace_tpu", "scripts"))
    assert len(sources) > 100
    assert_same(sources)


def test_every_port_module_equal_and_clean():
    sources = tcollect(REPO)
    assert len(sources) > 60 and all(p.startswith("devspace_tpu_torch") for p, _ in sources)
    assert assert_same(sources) == []
    assert tcollect(REPO) == jcollect(REPO, ("devspace_tpu_torch",))
