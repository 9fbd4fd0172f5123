"""Profiling for training workloads on ``torch.profiler``.

Counterpart of ``devspace_tpu/training/profiler.py``: capture a window
of host and device activity into a trace viewable in Perfetto or
``chrome://tracing`` (the reference's TensorBoard layout:
``<log_dir>/plugins/profile/<run>/<host>.pt.trace.json``), mark step
boundaries and named regions, and read the device's memory for OOM
hunting.

Usage in a train loop::

    from devspace_tpu_torch.training.profiler import profile, step_annotation

    with profile(".devspace/profiles") as prof:   # capture a window
        for i in range(10):
            with step_annotation(i):               # named step boundaries
                state, loss = step_fn(state, batch)
        torch.cuda.synchronize()
    prof.key_averages()                            # device time by kernel
"""

from __future__ import annotations

import os
import socket
import time
from contextlib import contextmanager
from typing import Iterator, Optional, Union

import torch
from torch.profiler import ProfilerActivity, record_function


@contextmanager
def profile(log_dir: str) -> Iterator[torch.profiler.profile]:
    """Profile the block: host operations, and the card's kernels and
    copies where CUDA is available. Yields the ``torch.profiler.profile``
    (``key_averages()`` once the block has ended); writes its Chrome
    trace under ``<log_dir>/plugins/profile/<run>/`` when it ends."""
    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    run_dir = os.path.join(log_dir, "plugins", "profile", time.strftime("%Y_%m_%d_%H_%M_%S"))
    os.makedirs(run_dir, exist_ok=True)
    prof = torch.profiler.profile(activities=activities)
    with prof:
        yield prof
    prof.export_chrome_trace(os.path.join(run_dir, f"{socket.gethostname()}.pt.trace.json"))


def step_annotation(step: int, name: str = "train"):
    """Mark one training step in the profile (``<name>#<step>``, the
    form of torch's own ``ProfilerStep#N``)."""
    return record_function(f"{name}#{step}")


def annotate(name: str):
    """A named region in the profile (context manager): wrap a host
    phase (data loading, checkpointing) to see it on the host timeline
    beside the device's."""
    return record_function(name)


def device_memory_stats(device: Optional[Union[str, torch.device]] = None) -> dict:
    """The card's memory: ``bytes_in_use``, ``peak_bytes_in_use`` (of
    PyTorch's allocator) and ``bytes_limit`` (the card's total). A CPU,
    or no CUDA, reports ``{}``."""
    if device is None:
        if not torch.cuda.is_available():
            return {}
        device = torch.device("cuda", torch.cuda.current_device())
    device = torch.device(device)
    if device.type != "cuda":
        return {}
    stats = torch.cuda.memory_stats(device)
    return {"bytes_in_use": stats.get("allocated_bytes.all.current", 0),
            "peak_bytes_in_use": stats.get("allocated_bytes.all.peak", 0),
            "bytes_limit": torch.cuda.get_device_properties(device).total_memory}


def memory_summary() -> str:
    """One line per local card: in use, peak and limit in GiB; ``cpu: no
    memory stats available`` without CUDA."""
    if not torch.cuda.is_available():
        return "cpu: no memory stats available"
    lines = []
    gib = 1 << 30
    for i in range(torch.cuda.device_count()):
        dev = torch.device("cuda", i)
        stats = device_memory_stats(dev)
        in_use, peak, limit = (stats[k] for k in ("bytes_in_use", "peak_bytes_in_use",
                                                   "bytes_limit"))
        lines.append(f"{dev}: {in_use / gib:.2f} GiB in use, peak {peak / gib:.2f} GiB, "
                     f"limit {limit / gib:.2f} GiB ({100 * in_use / limit:.0f}%)")
    return "\n".join(lines)


def save_device_profile(log_dir: str, duration_ms: int = 3000) -> str:
    """Profile this process for ``duration_ms`` while its other threads
    keep running (live debugging), then return ``log_dir``."""
    with profile(log_dir):
        time.sleep(duration_ms / 1000)
    return log_dir
