"""The port's runtime tripwires (devspace_tpu_torch/lint/runtime.py).

- ``LockOrderMonitor`` / ``OrderedLock``, a plain copy: the acquisition
  scripts of tests/test_lint_runtime.py give the reference's monitor and
  the port's equal edges, violations and ``compare()`` results.
- ``CompileWatch`` over program builds: a TINY ``device="cpu"`` engine
  runs a warm wave, then an identical wave under the watch, with count 0
  (equal to the engine's ``graph_captures`` delta); a program key the
  warm wave did not build counts 1 and ``assert_no_recompiles`` raises;
  every table of the process counts, two engines' included; a CPU build
  followed by its run counts once. The card's half is
  tests/test_torch_graphs_cuda.py::test_compile_watch_counts_captures_on_the_card.
"""

import threading

import numpy as np
import pytest
import torch

from devspace_tpu.lint import runtime as jrt
from devspace_tpu.lint import extract_lock_graph as jgraph
from devspace_tpu_torch.inference import InferenceEngine, graphs
from devspace_tpu_torch.lint import extract_lock_graph as tgraph
from devspace_tpu_torch.lint import runtime as trt
from devspace_tpu_torch.models import transformer as tfm

STATIC_SRC = (
    "import threading\n"
    "class Pool:\n"
    "    def __init__(self):\n"
    "        self._alloc = threading.Lock()\n"
    "        self._stats = threading.Lock()\n"
    "    def take(self):\n"
    "        with self._alloc:\n"
    "            with self._stats:\n"
    "                pass\n"
)


def nested(a, b):
    with a:
        with b:
            pass


def script_pair(rt, mon):
    a, b = rt.OrderedLock("a", mon), rt.OrderedLock("b", mon)
    nested(a, b)


def script_inversion(rt, mon):
    a, b = rt.OrderedLock("a", mon), rt.OrderedLock("b", mon)
    nested(a, b)
    nested(b, a)


def script_reentrant(rt, mon):
    a = rt.OrderedLock("a", mon, reentrant=True)
    nested(a, a)


def script_threads(rt, mon):
    a, b = rt.OrderedLock("alloc", mon), rt.OrderedLock("stats", mon)
    done = threading.Event()

    def t1():
        nested(a, b)
        done.set()

    def t2():
        done.wait(5)
        nested(b, a)

    threads = [threading.Thread(target=t1, name="t1"), threading.Thread(target=t2, name="t2")]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=10)
        assert not t.is_alive()


def script_static(rt, mon):
    alloc, stats = rt.OrderedLock("_alloc", mon), rt.OrderedLock("_stats", mon)
    t = threading.Thread(target=nested, args=(stats, alloc), name="w")
    t.start()
    t.join(timeout=10)
    assert not t.is_alive()


def observed(rt, graph_fn, script):
    mon = rt.LockOrderMonitor()
    script(rt, mon)
    return {
        "edges": mon.ordered_edges(),
        "violations": [(v.outer, v.inner, v.thread, v.source) for v in mon.violations()],
        "compare": [(v.outer, v.inner, v.thread, v.source)
                    for v in mon.compare(graph_fn("pool.py", STATIC_SRC))],
    }


@pytest.mark.parametrize("script", [script_pair, script_inversion, script_reentrant,
                                    script_threads, script_static])
def test_lock_monitor_equals_the_reference(script):
    got = observed(trt, tgraph, script)
    assert got == observed(jrt, jgraph, script)
    if script is script_static:
        assert got["compare"] == [("_stats", "_alloc", "w", "static")]
    if script is script_threads:
        assert got["violations"] == [("stats", "alloc", "t2", "runtime")]


def test_ordered_lock_and_monitor_basics():
    mon = trt.LockOrderMonitor()
    a = trt.OrderedLock("a", mon)
    assert a.acquire() and a.locked()
    a.release()
    assert not a.locked() and mon.compare(None) == []
    assert trt.get_monitor() is trt.OrderedLock("x").monitor
    mon.reset()
    assert mon.ordered_edges() == [] and mon.violations() == []


def test_compile_watch_requires_start():
    watch = trt.CompileWatch()
    assert watch.count == 0
    with pytest.raises(RuntimeError):
        watch.reset()
    with pytest.raises(RuntimeError):
        watch.stop()


@pytest.fixture(scope="module")
def params():
    return tfm.init_params(tfm.TINY, torch.Generator().manual_seed(0))


def prompts(n=2, seed=0):
    rng = np.random.default_rng(seed)
    return [rng.integers(1, tfm.TINY.vocab_size, size=int(rng.integers(4, 24))).tolist()
            for _ in range(n)]


def wave(engine, ps, n_new=8, **kw):
    for h in [engine.submit(p, n_new, **kw) for p in ps]:
        h.result(timeout=120)


def make_engine(params):
    return InferenceEngine(params, tfm.TINY, device="cpu", max_slots=2, max_len=64,
                           chunk_max=4, block_size=16)


def test_warm_engine_builds_nothing_in_an_identical_wave(params):
    engine = make_engine(params).start()
    try:
        with trt.CompileWatch("tiny") as watch:
            # warm-up: one request alone decodes its 7 steps as chunks of
            # 4, 2 and 1, so every greedy program is built; then the wave
            wave(engine, prompts(1))
            wave(engine, prompts())
            warm = engine.stats()["graph_captures"]
            assert watch.count == warm == len(engine._chunk_sizes()) == 3
            watch.reset()
            wave(engine, prompts())
        assert watch.count == 0 == engine.stats()["graph_captures"] - warm
        watch.assert_no_recompiles()
        # a sampling mode the warm waves never used is a new program key
        watch = trt.CompileWatch("tiny").start()
        wave(engine, prompts(1), n_new=2, temperature=0.8, seed=3)  # one decode step
        assert watch.stop() == 1 == engine.stats()["graph_captures"] - warm
    finally:
        engine.stop()
    with pytest.raises(trt.RecompileError, match=r"\[tiny\]: 1 program build"):
        watch.assert_no_recompiles()


def test_every_table_counts_once_per_build(params):
    """Two engines' tables feed one process-wide count; a CPU ``build``
    and its ``run`` count once, as ``captures`` does."""
    a, b = make_engine(params), make_engine(params)
    key = a._programs.keys()[0]
    watch = trt.CompileWatch().start()
    a._programs.build(key)
    a._programs.run(key)
    b._programs.run(key)
    b._programs.build(key)
    assert watch.count == 2 == a._programs.captures + b._programs.captures
    assert trt.compile_count() == graphs.CAPTURES
    assert watch.stop() == 2
