#!/usr/bin/env python3
"""Where the paged-decode kernel's time goes, on the card.

    python3 scripts/probe_paged_decode.py [--source PATH] [--splits 1,2,4] [--stages 2,3,4]

Builds ``devspace_tpu_torch/csrc/paged_decode.cu`` (or ``--source``, for
example the same file in a ``git archive`` copy of an older commit)
three ways with nvcc: as it is (``full``), with the per-tile math taken
out (``loads``: tiles are still copied into shared memory, nothing is
computed from them) and with the loads taken out (``math``: the math
runs on whatever shared memory holds). Each build is timed at a
Llama-2-7B decode step's attention (B = 8 rows, every length 1024, or
``--batch`` and ``--length``; H = Hkv = 32, D = 128, block 64; q bf16,
pool bf16 or int8), or with ``--verify`` at the speculative path's
verification rows with CUDA events
around 200 launches queued behind a spin kernel
(``chip_smoke.device_ms``), beside the bytes bound (``chip_smoke.bound``).

The split design (a source whose C entry point takes ``n_split``) marks
its loads and its math with ``PAGED_DECODE_PROBE`` (1: loads only, 2:
math only) and is timed at each split count of ``--splits`` and ring
depth of ``--stages`` (0: the wrapper's own plan). The first design (PR
1), which has no such marks, is cut by text edits of its source. The
numbers attribute time and nothing else: a build without loads or math
computes nothing meaningful. One JSON line per build, variant and
setting.
"""

from __future__ import annotations

import argparse
import ctypes
import json
import os
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT))

import torch  # noqa: E402

import chip_smoke as cs  # noqa: E402
from devspace_tpu_torch.ops import _build  # noqa: E402
from devspace_tpu_torch.ops import paged_attention as pa  # noqa: E402

VARIANTS = {"full": 0, "loads": 1, "math": 2}
B, LENGTH, H, HKV, D, BS = 8, 1024, 32, 32, 128, 64

# the first design's tile loop: its loads, and its math (scores, softmax
# and P.V), each wrapped in a guard that the probe's macro switches off
FIRST_DESIGN_CUTS = (
    ("    copy_tile(k_tile, pool_k",
     "#if PAGED_DECODE_PROBE != 2\n    copy_tile(k_tile, pool_k"),
    ("        vsc[t] = v_scale[tile * bs + t];\n      }\n    }\n",
     "        vsc[t] = v_scale[tile * bs + t];\n      }\n    }\n#endif\n"),
    ("    // scores: one warp per position", "#if PAGED_DECODE_PROBE != 1\n    // scores: one warp per position"),
    ("      acc[i] = a;\n    }\n", "      acc[i] = a;\n    }\n#endif\n"),
)


def probe_source(source: Path, out_dir: Path) -> tuple[Path, bool]:
    """The source to build (the first design gets its guards written in)
    and whether it has the split design's entry point."""
    text = source.read_text()
    split = "n_split" in text
    if "PAGED_DECODE_PROBE" in text:
        return source, split
    for old, new in FIRST_DESIGN_CUTS:
        assert text.count(old) == 1, f"{source}: cannot find {old!r}"
        text = text.replace(old, new)
    text = "#ifndef PAGED_DECODE_PROBE\n#define PAGED_DECODE_PROBE 0\n#endif\n" + text
    patched = out_dir / "paged_decode_first_design.cu"
    patched.write_text(text)
    return patched, split


def build(source: Path, out_dir: Path) -> dict[str, Path]:
    """One nvcc per variant, all started together."""
    include = ["-I", str(source.parent), "-I", str(_build.CSRC_DIR)]
    procs = {}
    for name, macro in VARIANTS.items():
        lib = out_dir / f"libpaged_decode_{name}.so"
        cmd = [_build.nvcc_path(), *_build.NVCC_FLAGS, f"-DPAGED_DECODE_PROBE={macro}", *include,
               "-o", str(lib), str(source)]
        procs[name] = (lib, subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                             stderr=subprocess.STDOUT, text=True))
    libs = {}
    for name, (lib, proc) in procs.items():
        log = proc.communicate()[0]
        if proc.returncode:
            raise RuntimeError(f"nvcc failed for the {name} variant:\n{log}")
        cs.emit({"build": name, "ptxas": [ln.strip() for ln in log.splitlines()
                                          if "registers" in ln or "spill" in ln]})
        libs[name] = lib
    return libs


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--source", type=Path, default=_build.CSRC_DIR / "paged_decode.cu")
    ap.add_argument("--splits", default="0")
    ap.add_argument("--stages", default="0")
    ap.add_argument("--batch", type=int, default=B, help="rows (default 8)")
    ap.add_argument("--length", type=int, default=LENGTH, help="every row's length (1024)")
    ap.add_argument("--verify", action="store_true",
                    help="the speculative path's [40, 8, 128] verification rows instead "
                         "(chip_smoke.verify_inputs, bf16 pool)")
    ap.add_argument("--reps", type=int, default=200)
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("probe_paged_decode: CUDA is not available", file=sys.stderr)
        return 1
    dev = torch.device("cuda", 0)
    card = cs.card_line()
    out_dir = ROOT / "devspace_tpu_torch" / "_build" / "probe" / str(os.getpid())
    out_dir.mkdir(parents=True, exist_ok=True)
    source, split = probe_source(args.source.resolve(), out_dir)
    libs = build(source, out_dir)
    splits = [int(s) for s in args.splits.split(",")]
    stages = [int(s) for s in args.stages.split(",")]
    if args.verify:
        cases = {"verify": cs.verify_inputs(3, torch.bfloat16, dev)}
    else:
        cases = {pool: cs.paged_inputs(2, [args.length] * args.batch, H, HKV, D, BS,
                                       torch.bfloat16, pool == "int8", dev)
                 for pool in ("bf16", "int8")}
    lines = []
    for pool, (q, pk, pv, tables, lengths, ks, vs) in cases.items():
        int8 = pool == "int8"
        b, h, d = q.shape
        _, hkv, bs, _ = pk.shape
        # verification rows share their slot's blocks: the bound reads them once a slot
        kv_lens = lengths.view(-1, cs.SPEC_K + 1).amax(1) if args.verify else None
        bound_ms, bound_by = cs.bound(q, pk, tables, lengths, int8, kv_lens)
        ref = pa.paged_decode_reference(q, pk, pv, tables, lengths, ks, vs)
        for name, lib_path in libs.items():
            fn = ctypes.CDLL(str(lib_path)).paged_decode
            fn.restype = ctypes.c_int
            for n_split in splits if split else [1]:
                for n_stages in stages if split else [0]:
                    out = torch.empty_like(q)
                    raw = [1, int(int8), q.data_ptr(), pk.data_ptr(), pv.data_ptr(),
                           ks.data_ptr() if int8 else None, vs.data_ptr() if int8 else None,
                           tables.data_ptr(), lengths.data_ptr(), out.data_ptr(),
                           b, h, hkv, d, bs, tables.shape[1], pk.shape[0]]
                    argtypes = [ctypes.c_int] * 2 + [ctypes.c_void_p] * 8 + [ctypes.c_int] * 7
                    plan = None
                    if split:
                        plan = pa.plan_splits(b, hkv, tables.shape[1], bs, d, pk.element_size(),
                                              int8)
                        if n_split:
                            plan = plan._replace(n_split=n_split)
                        if n_stages:
                            plan = plan._replace(stages=n_stages)
                        scratch = torch.empty(pa.scratch_floats(plan, b, h, d), device=dev)
                        raw += [plan.n_split, plan.stages, scratch.data_ptr()]
                        argtypes += [ctypes.c_int] * 2 + [ctypes.c_void_p]
                    fn.argtypes = argtypes + [ctypes.c_void_p]
                    stream = torch.cuda.current_stream().cuda_stream

                    def launch():
                        err = fn(*raw, stream)
                        if err:
                            raise RuntimeError(f"launch failed: cudaError {err}")

                    ms, _ = cs.device_ms(launch, args.reps)
                    line = {"variant": name, "pool": pool, "card": card, "batch": b,
                            "length": None if args.verify else args.length,
                            "ms": ms, "bound_ms": bound_ms, "bound_by": bound_by,
                            "bound_share": bound_ms / ms}
                    if plan is not None:
                        line.update(n_split=plan.n_split, stages=plan.stages)
                    if name == "full":  # read back once, after every timing
                        line["max_abs_err"] = (out.float() - ref.float()).abs().max()
                    lines.append(line)
    errs = torch.stack([ln["max_abs_err"] for ln in lines if "max_abs_err" in ln]).tolist()
    for line in lines:
        if "max_abs_err" in line:
            line["max_abs_err"] = errs.pop(0)
        cs.emit(line)
    return 0


if __name__ == "__main__":
    sys.exit(main())
