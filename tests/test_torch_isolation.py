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
        "bad = sorted(m for m in added if m.split('.')[0] in ('jax', 'jaxlib', 'devspace_tpu'))\n"
        "assert not bad, bad\n"
        "print('ok', len(added))\n"
    )
    out = subprocess.run([sys.executable, "-c", code], cwd=REPO, capture_output=True,
                         text=True, timeout=120)
    assert out.returncode == 0, out.stdout + out.stderr
    assert out.stdout.startswith("ok")
    assert "devspace_tpu_torch.inference.engine" in MODULES and len(MODULES) >= 12


def imported_names(path: Path) -> list[str]:
    names = []
    for node in ast.walk(ast.parse(path.read_text(), str(path))):
        if isinstance(node, ast.Import):
            names += [a.name for a in node.names]
        elif isinstance(node, ast.ImportFrom) and node.level == 0 and node.module:
            names.append(node.module)
    return names


def test_no_source_imports_jax_or_the_jax_package():
    files = sorted(PACKAGE.rglob("*.py")) + [REPO / "chip_smoke.py"]
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
