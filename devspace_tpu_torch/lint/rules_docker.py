"""Dockerfile lint for the images the port scaffolds and builds.

The counterpart of ``devspace_tpu/lint/rules_docker.py`` (IMG401-404),
with the TPU flavour's checks turned into the card's. A workload image
for the port must carry the CUDA toolkit with ``nvcc``, because
``ops/_build.py`` compiles ``csrc/*.cu`` at the first launch of each
kernel: an image built on a CUDA ``-runtime`` base starts, then fails
there. It must carry torch built for CUDA (a CPU wheel never sees the
card), and no TPU-only client stack. All of it is readable from the
Dockerfile's text, so it belongs in the preflight, not in a post-boot
log dive.
"""

from __future__ import annotations

import re
from typing import Iterator

from .engine import ERROR, Finding, LintContext, WARNING, rule

_TPU_STACK = re.compile(r"jax\s*\[\s*tpu\s*\]|libtpu", re.IGNORECASE)
_TPU_ENV = re.compile(r"^(TPU_|JAX_PLATFORMS)", re.IGNORECASE)
# base images that ship the CUDA toolkit (nvcc): NVIDIA's -devel images,
# pytorch/pytorch's -devel tags, and NGC's PyTorch images
_DEVEL_BASE = re.compile(
    r"(^|/)cuda:.*-devel|^pytorch/pytorch:.*-devel|^nvcr\.io/nvidia/pytorch:",
    re.IGNORECASE,
)
_NVCC_INSTALL = re.compile(r"cuda-(nvcc|toolkit)|nvidia-cuda-nvcc", re.IGNORECASE)
# base images that ship torch built for CUDA
_TORCH_BASE = re.compile(r"^pytorch/pytorch:|^nvcr\.io/nvidia/pytorch:", re.IGNORECASE)
_TORCH_INSTALL = re.compile(r"\bpip3?\s+install\b.*\btorch\b", re.IGNORECASE)
_CPU_WHEEL = re.compile(r"whl/cpu|\+cpu\b", re.IGNORECASE)
_LAUNCHERS = ("python", "torchrun")


def parse_instructions(text: str) -> list[tuple[str, str]]:
    """(KEYWORD, rest) per logical Dockerfile instruction; comments
    stripped, backslash continuations joined."""
    out: list[tuple[str, str]] = []
    logical = ""
    for raw in text.splitlines():
        line = raw.strip()
        if not line or line.startswith("#"):
            continue
        if line.endswith("\\"):
            logical += line[:-1] + " "
            continue
        logical += line
        parts = logical.split(None, 1)
        if parts:
            out.append((parts[0].upper(), parts[1] if len(parts) > 1 else ""))
        logical = ""
    if logical.strip():
        parts = logical.split(None, 1)
        out.append((parts[0].upper(), parts[1] if len(parts) > 1 else ""))
    return out


def _final_stage(instructions: list[tuple[str, str]]) -> tuple[str, list]:
    """Base image and instructions of the LAST build stage (multi-stage
    builds ship only the final stage)."""
    base, stage = "", []
    for kw, rest in instructions:
        if kw == "FROM":
            base, stage = (rest.split()[0] if rest.split() else ""), []
        else:
            stage.append((kw, rest))
    return base, stage


def _entrypoint_text(instructions: list[tuple[str, str]]) -> str:
    """The effective process line: last ENTRYPOINT + last CMD."""
    cmd = entry = ""
    for kw, rest in instructions:
        if kw == "CMD":
            cmd = rest
        elif kw == "ENTRYPOINT":
            entry = rest
    return f"{entry} {cmd}".strip()


def _each_dockerfile(ctx: LintContext) -> Iterator[tuple[str, list, bool]]:
    for path, text, gpu_flavor in ctx.dockerfiles or ():
        yield path, parse_instructions(text), bool(gpu_flavor)


def _image_finding(rule_id: str, severity: str, path: str, message: str) -> Finding:
    return Finding(rule_id=rule_id, severity=severity, category="image",
                   message=message, artifact=path)


@rule(
    "IMG401",
    severity=ERROR,
    category="image",
    description="GPU workload images must carry the CUDA toolkit (nvcc, "
    "the kernels build at first launch) and torch built for CUDA",
)
def check_gpu_stack(ctx: LintContext):
    for path, instructions, gpu_flavor in _each_dockerfile(ctx):
        if not gpu_flavor:
            continue
        base, stage = _final_stage(instructions)
        runs = [rest for kw, rest in stage if kw == "RUN"]
        if not (_DEVEL_BASE.search(base) or any(_NVCC_INSTALL.search(r) for r in runs)):
            yield _image_finding(
                "IMG401", ERROR, path,
                f"base image {base!r} has no CUDA toolkit and no RUN installs "
                f"one — the port builds csrc/*.cu with nvcc at the first "
                f"launch of each kernel; use a CUDA -devel base",
            )
        torch_runs = [r for r in runs if _TORCH_INSTALL.search(r)]
        if not (_TORCH_BASE.search(base) or torch_runs):
            yield _image_finding(
                "IMG401", ERROR, path,
                "no torch: install torch built for CUDA (or start from a "
                "pytorch/pytorch -devel image)",
            )
        for r in torch_runs:
            if _CPU_WHEEL.search(r):
                yield _image_finding(
                    "IMG401", ERROR, path,
                    f"torch installed from a CPU wheel ({r!r}) — it never "
                    f"sees the card",
                )


@rule(
    "IMG402",
    severity=ERROR,
    category="image",
    description="GPU workload images must not carry a TPU-only stack "
    "(jax[tpu]/libtpu, TPU_* env)",
)
def check_base_image(ctx: LintContext):
    for path, instructions, gpu_flavor in _each_dockerfile(ctx):
        base, _ = _final_stage(instructions)
        if not base:
            yield _image_finding(
                "IMG402", ERROR, path,
                "no FROM instruction — not a buildable Dockerfile",
            )
            continue
        if not gpu_flavor:
            continue
        if any((kw == "RUN" and _TPU_STACK.search(rest))
               or (kw == "ENV" and _TPU_ENV.match(rest)) for kw, rest in instructions):
            yield _image_finding(
                "IMG402", ERROR, path,
                "TPU-only stack (jax[tpu]/libtpu or TPU_*/JAX_PLATFORMS env) "
                "in a GPU workload image — GPU nodes expose nvidia.com/gpu, "
                "not google.com/tpu",
            )


@rule(
    "IMG403",
    severity=ERROR,
    category="image",
    description="Images need a CMD or ENTRYPOINT",
)
def check_entrypoint_present(ctx: LintContext):
    for path, instructions, _ in _each_dockerfile(ctx):
        if not _entrypoint_text(instructions):
            yield _image_finding(
                "IMG403", ERROR, path,
                "no CMD or ENTRYPOINT — the container has nothing to "
                "run (dev-mode entrypoint overrides need a baseline "
                "process to replace)",
            )


@rule(
    "IMG404",
    severity=WARNING,
    category="image",
    description="GPU workload entrypoints should invoke python or "
    "torchrun",
)
def check_python_entrypoint(ctx: LintContext):
    for path, instructions, gpu_flavor in _each_dockerfile(ctx):
        if not gpu_flavor:
            continue
        effective = _entrypoint_text(instructions)
        if effective and not any(w in effective.lower() for w in _LAUNCHERS):
            yield _image_finding(
                "IMG404", WARNING, path,
                f"entrypoint {effective!r} invokes neither python nor "
                f"torchrun — a torch workload is driven by a python process",
            )


def lint_dockerfile(
    text: str, path: str = "Dockerfile", gpu_flavor: bool = False
) -> list[Finding]:
    """Run the image rule pack over one Dockerfile's text."""
    from .engine import run_rules

    ctx = LintContext(dockerfiles=[(path, text, gpu_flavor)])
    return run_rules(ctx, categories={"image"})
