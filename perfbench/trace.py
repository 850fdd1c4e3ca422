"""``torch.profiler`` over a run's last frames: device time by kernel, the
busy share of the traced window, and the breakdown the result line carries.

After ``chip_smoke.py:665-694`` (``Profile``, the port at commit fc1ed8f):
busy time is the sum of the device's kernel rows (CPU-op rows repeat
their kernels' time).  Here the kernel intervals are also merged on the
timeline, so overlapping kernels count once, and the gaps between them
are labelled by the host operation that overlaps most of each.
"""

from __future__ import annotations

import time
from typing import Dict, List, Tuple

import torch


def _sync():
    if torch.cuda.is_available():
        torch.cuda.synchronize()


class Profile:
    def __init__(self):
        _sync()
        acts = [torch.profiler.ProfilerActivity.CPU, torch.profiler.ProfilerActivity.CUDA]
        self.prof = torch.profiler.profile(activities=acts)
        self.prof.__enter__()
        self.t0 = time.perf_counter()

    def stop(self) -> dict:
        _sync()
        wall = time.perf_counter() - self.t0
        self.prof.__exit__(None, None, None)
        kernels: Dict[str, float] = {}
        for e in self.prof.key_averages():
            if e.device_type == torch.autograd.DeviceType.CUDA and not e.is_user_annotation:
                kernels[e.key] = kernels.get(e.key, 0.0) + e.self_device_time_total / 1e6
        dev, host = _intervals(self.prof.events())
        busy = _merged_length(dev)
        return dict(wall_s=wall, busy_s=busy, kernels=kernels,
                    device_ops=sorted(kernels.items(), key=lambda kv: -kv[1])[:10],
                    idle_gaps=_idle_gaps(dev, host)[:10])


def _intervals(events):
    """(device kernel intervals, host op intervals with names), in s."""
    dev: List[Tuple[float, float]] = []
    host: List[Tuple[float, float, str]] = []
    for e in events:
        tr = e.time_range
        if e.device_type == torch.autograd.DeviceType.CUDA:
            if not e.is_user_annotation:
                dev.append((tr.start / 1e6, tr.end / 1e6))
        elif tr.end > tr.start:
            host.append((tr.start / 1e6, tr.end / 1e6, e.name))
    dev.sort()
    return dev, host


def _merged_length(iv: List[Tuple[float, float]]) -> float:
    total, cur_s, cur_e = 0.0, None, None
    for s, e in iv:
        if cur_e is None or s > cur_e:
            if cur_e is not None:
                total += cur_e - cur_s
            cur_s, cur_e = s, e
        else:
            cur_e = max(cur_e, e)
    if cur_e is not None:
        total += cur_e - cur_s
    return total


def _idle_gaps(dev, host) -> List[List]:
    """The device's idle gaps between kernels, longest first, each named by
    the host operation that overlaps most of it (the shortest of equals),
    or by the kernel that ends it where no recorded host operation does."""
    gaps = []
    end = None
    for s, e in dev:
        if end is not None and s > end:
            gaps.append((s - end, end, s))
        end = e if end is None else max(end, e)
    gaps.sort(reverse=True)
    out = []
    for length, a, b in gaps[:10]:
        best = None
        for hs, he, name in host:
            ov = min(he, b) - max(hs, a)
            if ov > 0:
                key = (ov, -(he - hs))
                if best is None or key > best[0]:
                    best = (key, name)
        out.append([best[1] if best else "host (no recorded operation)", length])
    return out
