"""The port stands alone: it imports neither JAX nor anything of the JAX
package, and its kernel build targets Hopper."""

import ast
import os
import subprocess
import sys
from pathlib import Path

from devspace_tpu_torch.ops import _build

REPO = Path(__file__).resolve().parent.parent
PACKAGE = REPO / "devspace_tpu_torch"
MODULES = sorted(
    ".".join(p.relative_to(REPO).with_suffix("").parts).removesuffix(".__init__")
    for p in PACKAGE.rglob("*.py")
)


def test_every_module_imports_with_jax_blocked():
    # modules an interpreter start-up hook may have loaded already are
    # not the port's doing: only what the imports below add counts
    code = (
        "import sys\n"
        "before = set(sys.modules)\n"
        "sys.modules['jax'] = None\n"
        "import importlib\n"
        f"for name in {MODULES!r}:\n"
        "    importlib.import_module(name)\n"
        "added = set(sys.modules) - before - {'jax'}\n"
        "bad = sorted(m for m in added if m.split('.')[0] in ('jax', 'jaxlib', 'devspace_tpu',\n"
        "                                                      'flax', 'optax'))\n"
        "assert not bad, bad\n"
        "print('ok', len(added))\n"
    )
    out = subprocess.run([sys.executable, "-c", code], cwd=REPO, capture_output=True,
                         text=True, timeout=120)
    assert out.returncode == 0, out.stdout + out.stderr
    assert out.stdout.startswith("ok")
    assert "devspace_tpu_torch.inference.engine" in MODULES and len(MODULES) >= 12
    for name in ("dispatch", "graphs", "prefix_cache", "kv_tier", "quantization", "checkpoint"):
        assert f"devspace_tpu_torch.inference.{name}" in MODULES
    assert "devspace_tpu_torch.training.checkpoint" in MODULES
    assert "devspace_tpu_torch.resilience.policy" in MODULES
    for name in ("models.resnet", "models.mlp", "models.vit", "models.moe", "models.layers",
                 "models.convert", "parallel.expert_parallel", "training.data",
                 "training.profiler", "training.trainer", "parallel.mesh",
                 "parallel.collectives", "parallel.data_parallel", "parallel.tensor_parallel",
                 "parallel.ring_attention", "parallel.sequence_parallel", "parallel.fsdp",
                 "parallel.pipeline", "parallel.interleaved"):
        assert f"devspace_tpu_torch.{name}" in MODULES
    for name in ("obs", "obs.metrics", "obs.tracing", "obs.events", "obs.request_trace",
                 "obs.slo", "obs.fleet", "obs.collector", "serving", "serving.router",
                 "serving.gateway", "serving.fleet", "serving.stub", "serving.autoscale",
                 "serving.loadgen", "resilience.supervisor", "serve"):
        assert f"devspace_tpu_torch.{name}" in MODULES
    for name in ("lint", "lint.engine", "lint.reporters", "lint.pysource",
                 "lint.rules_concurrency", "lint.runtime", "lint.rules_hotpath",
                 "lint.rules_sharding", "lint.rules_obs", "lint.rules_manifest",
                 "lint.rules_docker", "generator", "generator.generator", "utils.topology"):
        assert f"devspace_tpu_torch.{name}" in MODULES
    # applying to a cluster: kube/ with its fake, builder/, analyze/, the
    # CLI and what they need of resilience/ and utils/
    for name in ("__main__", "kube", "kube.streams", "kube.websocket", "kube.kubeconfig",
                 "kube.transport", "kube.exec", "kube.portforward", "kube.client", "kube.fake",
                 "builder", "builder.dockerclient", "builder.registry", "builder.builders",
                 "builder.images", "analyze", "analyze.analyze", "cli", "cli.context",
                 "cli.pipeline", "cli.main", "resilience.chaos", "utils.randutil",
                 "utils.fsutil", "utils.dockerfile", "utils.trace"):
        assert f"devspace_tpu_torch.{name}" in MODULES


def imported_names(path: Path) -> list[str]:
    names = []
    for node in ast.walk(ast.parse(path.read_text(), str(path))):
        if isinstance(node, ast.Import):
            names += [a.name for a in node.names]
        elif isinstance(node, ast.ImportFrom) and node.level == 0 and node.module:
            names.append(node.module)
    return names


def test_no_source_imports_jax_or_the_jax_package():
    # the port's scripts run on the card too; scripts/convert_checkpoint.py
    # is the one script that imports both packages. The parallel tests'
    # worker processes run the port alone
    files = sorted(PACKAGE.rglob("*.py")) + [REPO / "chip_smoke.py"] + [
        REPO / "scripts" / f"train_{name}_torch.py"
        for name in ("draft_pair", "resnet", "mnist", "long_context")] + [
        REPO / "scripts" / f"{name}_torch.py"
        for name in ("analysis_gate", "chaos_serving_check", "chaos_check",
                     "fsdp_step_profile", "chaos_repeat", "port_teardown_probe")] + [
        REPO / "tests" / f"torch_parallel_{name}.py" for name in ("world", "workers")]
    bad = {
        str(f.relative_to(REPO)): name
        for f in files
        for name in imported_names(f)
        if name.split(".")[0] in ("jax", "jaxlib", "devspace_tpu", "flax", "optax")
    }
    assert not bad, bad


def test_nvcc_command_targets_sm90a(tmp_path):
    src = _build.CSRC_DIR / "paged_decode.cu"
    cmd = _build.nvcc_command(src, tmp_path / "lib.so")
    assert cmd[0].endswith("nvcc")
    assert "arch=compute_90a,code=sm_90a" in cmd
    for flag in ("-std=c++17", "-O3", "-shared", "-fPIC"):
        assert flag in cmd
    assert cmd[-1] == str(src) and str(tmp_path / "lib.so") in cmd
    # the library name follows the source's content, so an edited
    # source never loads a stale build
    lib = _build.library_path(src)
    assert lib.parent == _build.BUILD_DIR and lib.name.startswith("libpaged_decode-")


def test_every_kernel_source_builds_for_sm90a(tmp_path):
    sources = sorted(_build.CSRC_DIR.glob("*.cu"))
    assert {s.stem for s in sources} >= {"paged_decode", "flash_attention", "cross_entropy"}
    for src in sources:
        cmd = _build.nvcc_command(src, tmp_path / "lib.so")
        assert "arch=compute_90a,code=sm_90a" in cmd and cmd[-1] == str(src)
        assert _build.library_path(src).name.startswith(f"lib{src.stem}-")


def test_build_starts_every_source_and_reports_failures(tmp_path, monkeypatch):
    """``build`` runs one compiler process per source, all started before
    any is waited for, skips sources already built, and raises with the
    compiler's output when one fails. A stand-in compiler runs here."""
    csrc = tmp_path / "csrc"
    csrc.mkdir()
    for name in ("a", "b", "bad"):
        (csrc / f"{name}.cu").write_text(f"// {name}\n")
    monkeypatch.setattr(_build, "CSRC_DIR", csrc)
    monkeypatch.setattr(_build, "BUILD_DIR", tmp_path / "build")
    started = tmp_path / "started"
    started.mkdir()
    # each stand-in marks its start, then waits until all three started
    compiler = (
        "import pathlib, sys, time\n"
        "out, src = pathlib.Path(sys.argv[1]), pathlib.Path(sys.argv[2])\n"
        f"marks = pathlib.Path({str(started)!r})\n"
        "(marks / src.stem).touch()\n"
        "deadline = time.monotonic() + 60\n"
        "while len(list(marks.iterdir())) < 3 and time.monotonic() < deadline:\n"
        "    time.sleep(0.01)\n"
        "if src.stem == 'bad':\n"
        "    sys.exit('error: bad source')\n"
        "out.write_text('built')\n"
    )
    monkeypatch.setattr(_build, "nvcc_command",
                        lambda src, out: [sys.executable, "-c", compiler, str(out), str(src)])
    try:
        _build.build("a", "b", "bad")
    except RuntimeError as e:
        assert "bad.cu" in str(e) and "error: bad source" in str(e)
    else:
        raise AssertionError("a failed build must raise")
    assert len(list(started.iterdir())) == 3
    assert _build.library_path(csrc / "a.cu").read_text() == "built"
    assert not _build.library_path(csrc / "bad.cu").exists()
    assert _build.build("a", "b") == {"a": None, "b": None}  # already built
