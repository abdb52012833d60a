"""The device trace of a traced run: ``torch.profiler`` over slices of a
few steps or a scene after the window, read back as intervals.

Two slices. The first records the device's activity alone, which slows
the host less than the second does: the device is busy where some kernel,
copy or fill runs (the union of their intervals, so overlapping work
counts once), and the slice lasts from the host's clock after a
synchronization at its start to one at its end. Busy time, idle share,
the kernels' times and the device operations come from it. The second
records the host's operators too, which slows the host: it only names
what the host was doing in the device's idle gaps."""

from __future__ import annotations

import contextlib
import json
import os
import tempfile
import time
from typing import Dict, List, Tuple

SLICE = "bench/slice"
DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")


def _union(ivs) -> List[Tuple[float, float]]:
    merged: List[Tuple[float, float]] = []
    for a, b in sorted((a, b) for a, b in ivs if b > a):
        if merged and a <= merged[-1][1]:
            merged[-1] = (merged[-1][0], max(merged[-1][1], b))
        else:
            merged.append((a, b))
    return merged


def _events(prof) -> List[Dict]:
    fd, path = tempfile.mkstemp(suffix=".json")
    os.close(fd)
    try:
        prof.export_chrome_trace(path)
        with open(path) as f:
            events = json.load(f)["traceEvents"]
    finally:
        os.remove(path)
    return [e for e in events if e.get("ph") == "X"]


class DeviceTrace:
    """After ``record_device``: ``window_s``, ``busy_s``, ``kernels`` (name
    -> [durations in s]) and ``ops`` (the device operations by total
    seconds); after ``record_host``: ``gaps`` (idle seconds by what the
    host was doing). ``units``: the steps or scenes in each slice."""

    def __init__(self, units: int):
        self.units = units
        self.gaps: List[Tuple[str, float]] = []

    @contextlib.contextmanager
    def record_device(self, torch):
        from torch.profiler import ProfilerActivity, profile

        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            yield
            torch.cuda.synchronize()
            window_s = time.perf_counter() - t0
        self.read_device(_events(prof), window_s)

    def read_device(self, spans: List[Dict], window_s: float) -> None:
        dev = [e for e in spans if e.get("cat") in DEVICE_CATS]
        merged = _union((float(e["ts"]), float(e["ts"]) + float(e["dur"]))
                        for e in dev)
        self.window_s = window_s
        self.busy_s = sum(b - a for a, b in merged) * 1e-6
        self.kernels: Dict[str, List[float]] = {}
        for e in dev:
            self.kernels.setdefault(e["name"], []).append(
                float(e["dur"]) * 1e-6)
        self.ops = sorted(((k[:96], sum(v)) for k, v in
                           self.kernels.items()), key=lambda x: -x[1])

    @contextlib.contextmanager
    def record_host(self, torch):
        from torch.profiler import ProfilerActivity, profile, record_function

        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            with record_function(SLICE):
                yield
                torch.cuda.synchronize()
        self.read_host(_events(prof))

    def read_host(self, spans: List[Dict]) -> None:
        sl = [e for e in spans if e.get("name") == SLICE
              and e.get("cat") == "user_annotation"]
        if not sl:
            raise RuntimeError("the trace has no slice span")
        t0 = float(sl[0]["ts"])
        t1 = t0 + float(sl[0]["dur"])
        merged = _union((max(float(e["ts"]), t0),
                         min(float(e["ts"]) + float(e["dur"]), t1))
                        for e in spans if e.get("cat") in DEVICE_CATS)
        self.gaps = _gaps(spans, merged, t0, t1)

    def kernel_seconds(self, needle: str) -> Tuple[float, int]:
        """(total seconds, launches) of the kernels whose name holds
        ``needle``."""
        durs = [d for k, v in self.kernels.items() if needle in k for d in v]
        return sum(durs), len(durs)

    def breakdown(self) -> Dict:
        return {"device_ops": [[k, v] for k, v in self.ops[:10]],
                "idle_gaps": [[k, v] for k, v in self.gaps[:10]]}


def _gaps(spans: List[Dict], merged, t0: float, t1: float
          ) -> List[Tuple[str, float]]:
    """Idle seconds by what the host was doing: the innermost benchmark
    span over the gap, and for the longest gaps the innermost operator
    too."""
    import numpy as np

    ann = [e for e in spans if e.get("cat") == "user_annotation"
           and e.get("name") != SLICE]
    ops = [e for e in spans if e.get("cat") == "cpu_op"]
    edges = [t0] + [x for iv in merged for x in iv] + [t1]
    gaps = [(a, b) for a, b in zip(edges[::2], edges[1::2]) if b > a]
    if not gaps:
        return []

    def table(evs):
        a = np.array([float(e["ts"]) for e in evs] or [0.0])
        d = np.array([float(e["dur"]) for e in evs] or [-1.0])
        return a, a + d, d

    def innermost(tab, evs, t):
        a, b, d = tab
        hit = np.nonzero((a <= t) & (t <= b))[0]
        if len(hit) == 0:
            return None
        return evs[hit[np.argmin(d[hit])]]["name"]

    ann_t, ops_t = table(ann), table(ops)
    order = sorted(range(len(gaps)), key=lambda i: gaps[i][0] - gaps[i][1])
    named = set(order[:300])
    out: Dict[str, float] = {}
    for i, (a, b) in enumerate(gaps):
        mid = (a + b) / 2
        name = innermost(ann_t, ann, mid) or "host"
        if i in named:
            op = innermost(ops_t, ops, mid)
            if op:
                name = f"{name} > {op}"
        name = name[:96]
        out[name] = out.get(name, 0.0) + (b - a) * 1e-6
    return sorted(out.items(), key=lambda x: -x[1])
