#!/usr/bin/env python3
"""Run chip_smoke.py's ``dev`` phase alone, from a checkout, and print its
result with the phase's seconds, one JSON line a run.

    python3 scripts/probe_dev_phase_torch.py [--checkout DIR] [--repeats N] [--device cpu]
    python3 scripts/probe_dev_phase_torch.py --scan [--repeats N]

``--scan`` runs no phase: it writes the phase's 10 000-file tree into a
temporary dir and scans it in this process (``chip_smoke.scan_tree``):
``walk_local_tree``, ``build_tar`` and ``directory_hash`` through the
port's libdevsync and again with ``DEVSPACE_NATIVE=0``, the results held
equal and each timed once a run.

``--checkout`` names the root of the checkout whose ``chip_smoke.py`` (and
so whose ``devspace_tpu_torch``) runs; by default the one this script is
in. To compare two commits on one machine, unpack each into its own dir
and run this script once for each, alternating. On the card the loss
kernel is built before the first run, so no run pays for nvcc; with
``--device cpu`` the phase runs as its CPU rehearsal does (101 steps,
``--device=cpu`` in worker 0). Each line carries the card's name and
power limit (``nvidia-smi``), or ``cpu``.
"""

from __future__ import annotations

import argparse
import json
import sys
import time
from pathlib import Path


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--checkout", default=str(Path(__file__).resolve().parent.parent))
    ap.add_argument("--repeats", type=int, default=1)
    ap.add_argument("--device", default="cuda", choices=["cuda", "cpu"])
    ap.add_argument("--scan", action="store_true")
    args = ap.parse_args()
    sys.path.insert(0, str(Path(args.checkout).resolve()))
    import torch

    import chip_smoke as cs

    if args.scan:
        return scan(cs, args, cs.card_line() if torch.cuda.is_available() else "cpu")

    if args.device == "cuda":
        if not torch.cuda.is_available():
            print("probe_dev_phase_torch: CUDA is not available", file=sys.stderr)
            return 1
        dev = torch.device("cuda", 0)
        card = cs.card_line()
        cs._build.build("cross_entropy")
    else:
        dev, card = torch.device("cpu"), "cpu"
        cs.DEV["steps"] = 101
    for run in range(args.repeats):
        t = time.monotonic()
        line = cs.phase_dev(dev, card)
        print(json.dumps({"checkout": args.checkout, "run": run, "card": card,
                          "phase_s": time.monotonic() - t, "seconds": line["seconds"],
                          "initial_sync_s": line["initial_sync_s"],
                          "edit_to_both_workers_s": line["edit_to_both_workers_s"],
                          "run_s": line["run_s"], "stop_s": line["stop_s"],
                          "xent_launches": line["xent_launches"],
                          "loss_at_check_step": line["loss_at_check_step"],
                          "scanner": line.get("scanner")}), flush=True)
    return 0


def scan(cs, args, card: str) -> int:
    import shutil
    import tempfile

    assert cs.native.build() is not None, "libdevsync did not build"
    root = tempfile.mkdtemp(prefix="scan-")
    try:
        t = time.monotonic()
        cs.write_sync_tree(root)
        write_s = time.monotonic() - t
        for run in range(args.repeats):
            print(json.dumps({"checkout": args.checkout, "run": run, "card": card,
                              "write_s": write_s, **cs.scan_tree(root, python=True)}),
                  flush=True)
    finally:
        shutil.rmtree(root, ignore_errors=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
