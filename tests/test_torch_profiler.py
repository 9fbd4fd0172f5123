"""The port's training profiler on the CPU: the counterpart of
tests/test_training.py::test_profiler_capture_and_memory_stats. A capture
lands in the reference's TensorBoard layout, step and region annotations
reach the profile, and the memory helpers answer without a card."""

import glob
import json
import os

import torch

from devspace_tpu_torch.training.profiler import (
    annotate,
    device_memory_stats,
    memory_summary,
    profile,
    save_device_profile,
    step_annotation,
)


def test_profiler_capture_and_memory_stats(tmp_path):
    log_dir = str(tmp_path / "profiles")
    x = torch.ones(64, 64)
    with profile(log_dir) as prof:
        for i in range(3):
            with step_annotation(i):
                out = (x @ x).sum()
        with annotate("blocking"):
            out.item()
    produced = glob.glob(os.path.join(log_dir, "plugins", "profile", "*", "*"))
    assert produced, "no profile artifacts written"
    with open(produced[0]) as f:
        names = {e.get("name") for e in json.load(f)["traceEvents"]}
    assert {"train#0", "train#1", "train#2", "blocking"} <= names
    assert any(e.key == "aten::mm" for e in prof.key_averages())
    assert isinstance(device_memory_stats(), dict)
    assert device_memory_stats("cpu") == {}
    assert memory_summary()


def test_save_device_profile_returns_its_dir(tmp_path):
    log_dir = str(tmp_path / "live")
    assert save_device_profile(log_dir, duration_ms=50) == log_dir
    assert glob.glob(os.path.join(log_dir, "plugins", "profile", "*", "*.pt.trace.json"))
