"""Profiling hooks (counterpart of gens_tpu/utils/profiling.py):

* :func:`trace` records the enclosed block with ``torch.profiler`` (the
  host, and the card when there is one) and writes a Chrome trace,
  ``<logdir>/trace.json`` (Perfetto or chrome://tracing read it);
* :class:`PhaseTimer` sums wall-clock time per named phase, waiting for the
  card when the phase's ``sync_value`` holds CUDA tensors;
* :func:`device_memory_stats` reads the caching allocator's usage of a
  CUDA device, and returns None for any other device.
"""

from __future__ import annotations

import contextlib
import os
import time
from collections import defaultdict
from typing import Dict, Optional

import torch


@contextlib.contextmanager
def trace(logdir: str):
    """Profile the enclosed block; yields the profiler. The trace is
    written to ``<logdir>/trace.json`` when the block ends."""
    from torch.profiler import ProfilerActivity, profile

    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    os.makedirs(logdir, exist_ok=True)
    with profile(activities=activities) as prof:
        yield prof
    prof.export_chrome_trace(os.path.join(logdir, "trace.json"))


def _cuda_devices(value) -> set:
    """The CUDA devices of the tensors in a tensor, list, tuple or dict."""
    if torch.is_tensor(value):
        return {value.device} if value.is_cuda else set()
    if isinstance(value, dict):
        value = list(value.values())
    if isinstance(value, (list, tuple)):
        return set().union(*(_cuda_devices(v) for v in value)) if value \
            else set()
    return set()


class PhaseTimer:
    """Accumulates wall-clock seconds per named phase; with ``sync`` on, a
    phase waits for the devices of its ``sync_value`` before it stops the
    clock, so the time covers the work it queued."""

    def __init__(self, sync: bool = True):
        self.sync = sync
        self.totals: Dict[str, float] = defaultdict(float)
        self.counts: Dict[str, int] = defaultdict(int)

    @contextlib.contextmanager
    def phase(self, name: str, sync_value=None):
        t0 = time.perf_counter()
        yield
        if self.sync:
            for dev in _cuda_devices(sync_value):
                torch.cuda.synchronize(dev)
        self.totals[name] += time.perf_counter() - t0
        self.counts[name] += 1

    def summary(self) -> Dict[str, float]:
        """Mean seconds per call of each phase."""
        return {k: self.totals[k] / max(self.counts[k], 1)
                for k in self.totals}

    def report(self) -> str:
        return "\n".join(
            f"  {k}: {v * 1e3:.1f} ms/call ({self.counts[k]} calls)"
            for k, v in sorted(self.summary().items()))


def device_memory_stats(device="cuda") -> Optional[Dict[str, float]]:
    """Memory of a CUDA device in GiB: in use, peak in use (since the last
    ``torch.cuda.reset_peak_memory_stats``) and the device's total. None
    for a device that is not CUDA."""
    device = torch.device(device)
    if device.type != "cuda":
        return None
    stats = torch.cuda.memory_stats(device)
    return {
        "bytes_in_use_gb": stats.get("allocated_bytes.all.current", 0)
        / 2 ** 30,
        "peak_bytes_gb": stats.get("allocated_bytes.all.peak", 0) / 2 ** 30,
        "bytes_limit_gb": torch.cuda.get_device_properties(
            device).total_memory / 2 ** 30,
    }
