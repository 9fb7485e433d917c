"""A slice of the measured window under ``torch.profiler``, device
activity only (kernels, copies, memsets: CUPTI's records, no host
operators), read into plain lists.

The host clock (``time.perf_counter``) and the profiler's clock are
tied by a marker: right after the slice starts, the host launches
``torch.cuda._sleep`` (ATen's ``spin_kernel``) and notes the time; that
kernel's start on the device, less the launch latency, gives the offset.
So each idle stretch of the device can be named by the host span that
was running then.
"""
from __future__ import annotations

import bisect
import time
from typing import Dict, List, Optional, Tuple

import torch

MARK = "spin_kernel"


class Slice:
    """Start with ``start()``, end with ``stop()`` at a point where the
    host has waited for the device; ``read()`` then gives the records."""

    def __init__(self) -> None:
        from torch.profiler import ProfilerActivity, profile
        self.prof = profile(activities=[ProfilerActivity.CUDA])
        self.t0 = self.t1 = self.t_mark = None

    def start(self) -> None:
        torch.cuda.synchronize()
        self.prof.start()
        self.t0 = time.perf_counter()
        self.t_mark = time.perf_counter()
        torch.cuda._sleep(1000)
        torch.cuda.synchronize()

    def stop(self) -> None:
        torch.cuda.synchronize()
        self.t1 = time.perf_counter()
        self.prof.stop()

    def read(self) -> Dict:
        """{"window_s", "busy_s", "kernels": [(name, start_s, dur_s)] on
        the host clock, sorted by start}; the marker is left out."""
        recs = _device_records(self.prof)
        mark = [r for r in recs if MARK in r[0]]
        if mark:
            offset = mark[0][1] - self.t_mark
        else:
            offset = (min(r[1] for r in recs) - self.t0) if recs else 0.0
        kernels = sorted((name, s - offset, d) for name, s, d in recs
                         if MARK not in name)
        from portbench.stats import union_s
        return {"window_s": self.t1 - self.t0,
                "busy_s": union_s((s, s + d) for _, s, d in kernels),
                "kernels": kernels, "t0": self.t0, "t1": self.t1}


def _device_records(prof) -> List[Tuple[str, float, float]]:
    """(name, start s, duration s) of every device record of ``prof``."""
    from torch.autograd import DeviceType
    out: List[Tuple[str, float, float]] = []
    res = getattr(getattr(prof, "profiler", None), "kineto_results", None)
    if res is not None:
        for e in res.events():
            if e.device_type() != DeviceType.CUDA:
                continue
            out.append((e.name(), e.start_ns() * 1e-9,
                        e.duration_ns() * 1e-9))
        return out
    for e in prof.events():
        if e.device_type == DeviceType.CUDA:
            out.append((e.name, e.time_range.start * 1e-6,
                        (e.time_range.end - e.time_range.start) * 1e-6))
    return out


def short_name(name: str) -> str:
    """A kernel's name without its trailing argument list."""
    if name.endswith(")"):
        depth = 0
        for i in range(len(name) - 1, -1, -1):
            depth += {")": 1, "(": -1}.get(name[i], 0)
            if depth == 0:
                name = name[:i] if i > 0 else name
                break
    return name[:160]


def label_at(t: float, spans: List[Tuple[float, float, str]],
             starts: List[float]) -> str:
    """The host span (sorted, not overlapping) that holds time ``t``, or
    "between calls"."""
    i = bisect.bisect_right(starts, t) - 1
    if i >= 0 and spans[i][0] <= t <= spans[i][1]:
        return spans[i][2]
    return "between calls"


def breakdown(tr: Dict, spans: Dict[str, List[Tuple[float, float]]]
              ) -> Optional[Dict]:
    """The device's ten costliest operations by name and its idle time
    by what the host was doing, in seconds."""
    from portbench.stats import gaps_between
    if not tr["kernels"]:
        return None
    ops: Dict[str, float] = {}
    for name, _, d in tr["kernels"]:
        key = short_name(name)
        ops[key] = ops.get(key, 0.0) + d
    idle: Dict[str, float] = {}
    host = sorted((a, b, label) for label, items in spans.items()
                  for a, b in items)
    starts = [a for a, _, _ in host]
    for a, b in gaps_between(((s, s + d) for _, s, d in tr["kernels"]),
                             tr["t0"], tr["t1"]):
        key = label_at((a + b) / 2, host, starts)
        idle[key] = idle.get(key, 0.0) + (b - a)
    top = sorted(ops.items(), key=lambda kv: -kv[1])[:10]
    gaps = sorted(idle.items(), key=lambda kv: -kv[1])[:10]
    return {"device_ops": [[k, v] for k, v in top],
            "idle_gaps": [[k, v] for k, v in gaps]}
