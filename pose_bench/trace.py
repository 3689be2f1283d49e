"""Spans and the profiler's reduction, and the arithmetic the metrics use.

Spans are CUDA events recorded at the boundaries of three calls on the
server (its ``detect``, its ``pose`` and the landmark model, by forward
hooks), opened by the benchmark without touching the program. The profile
of a stretch of clips is reduced to summaries: kernel time by name, the
union of device intervals (busy), the idle gaps named by the host
operation open during each, and kernel launches. No trace is written.
"""

from __future__ import annotations

import heapq
import math
from collections import defaultdict

import torch

LABEL = "pose_bench"  # prefix of every record_function label the benchmark opens
STRETCH = f"{LABEL}.stretch"


# -------------------------------------------------------------- arithmetic

def percentile(values, q: float) -> float:
    """The q-th percentile by linear interpolation between order statistics
    (numpy's default 'linear' method)."""
    xs = sorted(values)
    if not xs:
        raise ValueError("percentile of no values")
    pos = (len(xs) - 1) * q / 100.0
    lo = math.floor(pos)
    hi = min(lo + 1, len(xs) - 1)
    return xs[lo] + (xs[hi] - xs[lo]) * (pos - lo)


def merge(intervals):
    """Sorted, disjoint union of (start, end) intervals."""
    out = []
    for s, e in sorted(intervals):
        if out and s <= out[-1][1]:
            out[-1][1] = max(out[-1][1], e)
        else:
            out.append([s, e])
    return [tuple(x) for x in out]


def clipped(intervals, lo, hi):
    return [(max(s, lo), min(e, hi)) for s, e in intervals if e > lo and s < hi]


def union_length(intervals) -> float:
    return sum(e - s for s, e in merge(intervals))


def gaps(intervals, lo, hi):
    """The parts of [lo, hi] that no interval covers."""
    out, cur = [], lo
    for s, e in merge(clipped(intervals, lo, hi)):
        if s > cur:
            out.append((cur, s))
        cur = max(cur, e)
    if hi > cur:
        out.append((cur, hi))
    return out


def least_seconds(nbytes: float, ops: float, bytes_per_s: float, ops_per_s: float) -> float:
    """The roofline's least time: the larger of bytes over bandwidth and operations over peak."""
    return max(nbytes / bytes_per_s, ops / ops_per_s)


def roofline_pct(nbytes: float, ops: float, seconds: float, bytes_per_s: float, ops_per_s: float) -> float:
    return 100.0 * least_seconds(nbytes, ops, bytes_per_s, ops_per_s) / seconds


def mfu_pct(flops: float, seconds: float, peak: float) -> float:
    return 100.0 * flops / seconds / peak


# ------------------------------------------------------------------- spans

class Spans:
    """CUDA events around ``server.detect``, ``server.pose`` and the
    landmark model's forward, per clip; each call also opens a
    ``record_function`` label so a profile can name what the host was doing.
    :meth:`close` restores the server."""

    def __init__(self, server):
        self.server = server
        self.clips: list[dict] = []
        self._cur: dict = {}
        self._saved = {"detect": server.detect, "pose": server.pose}
        server.detect = self._wrap("detect", server.detect)
        server.pose = self._wrap("pose", server.pose)
        self._labels: list = []
        lm = server.landmarks
        self._hooks = [lm.register_forward_pre_hook(lambda *_: self._open("landmarks")),
                       lm.register_forward_hook(lambda *_: self._shut("landmarks"))]

    def _open(self, name):
        ev = torch.cuda.Event(enable_timing=True)
        ev.record()
        self._cur[name] = [ev, None]
        rf = torch.autograd.profiler.record_function(f"{LABEL}.{name}")
        rf.__enter__()
        self._labels.append(rf)

    def _shut(self, name):
        self._labels.pop().__exit__(None, None, None)
        ev = torch.cuda.Event(enable_timing=True)
        ev.record()
        self._cur[name][1] = ev

    def _wrap(self, name, fn):
        def call(*args, **kwargs):
            self._open(name)
            try:
                return fn(*args, **kwargs)
            finally:
                self._shut(name)
        return call

    def next_clip(self):
        if self._cur:
            self.clips.append(self._cur)
        self._cur = {}

    def close(self) -> list[dict[str, float]]:
        """Restore the server; per clip, each span's milliseconds."""
        self.next_clip()
        for h in self._hooks:
            h.remove()
        self.server.detect, self.server.pose = self._saved["detect"], self._saved["pose"]
        torch.cuda.synchronize()
        return [{k: a.elapsed_time(b) for k, (a, b) in clip.items()} for clip in self.clips]


# ---------------------------------------------------------------- profiler

def reduce_profile(prof) -> dict:
    """Summaries of a profile whose clips ran inside a ``STRETCH`` label:
    window_s (the label's wall time), busy_s (union of device activity),
    kernel launches, kernel_s (every kernel's seconds by its full name),
    device_ops (the heaviest kernels, names cut for the result line) and
    idle_gaps (idle seconds by the innermost host operation open mid-gap,
    under the benchmark's label)."""
    from torch.autograd import DeviceType

    events = list(prof.events())
    stretch = [e for e in events if e.name == STRETCH]
    if not stretch:
        raise RuntimeError("the profile holds no stretch label")
    lo = min(e.time_range.start for e in stretch)
    hi = max(e.time_range.end for e in stretch)
    device, host = [], []
    for e in events:
        if e.device_type == DeviceType.CUDA:
            # the benchmark's own labels come back on the device's timeline too, as annotations
            if not e.name.startswith(LABEL):
                device.append(e)
        elif e.name != STRETCH:
            host.append(e)
    dev_iv = clipped([(e.time_range.start, e.time_range.end) for e in device], lo, hi)
    kernels = [e for e in device if lo <= e.time_range.start < hi
               and not e.name.startswith(("Memcpy", "Memset"))]
    by_name: dict[str, float] = defaultdict(float)
    for e in kernels:
        by_name[e.name] += (e.time_range.end - e.time_range.start) * 1e-6
    idle = gaps(dev_iv, lo, hi)
    named = name_gaps(idle, [(e.time_range.start, e.time_range.end, e.name) for e in host])
    return {
        "window_s": (hi - lo) * 1e-6,
        "busy_s": union_length(dev_iv) * 1e-6,
        "launches": len(kernels),
        "kernel_s": dict(by_name),
        "device_ops": [[name[:160], s] for name, s in top(by_name)],
        "idle_gaps": top({k: v * 1e-6 for k, v in named.items()}),
    }


def name_gaps(gap_list, host) -> dict[str, float]:
    """Idle time (in the intervals' units) by what the host was doing at
    each gap's midpoint: the innermost benchmark label and the innermost
    operation open there ("<label>/<op>", "idle host" where none is)."""
    out: dict[str, float] = defaultdict(float)
    host = sorted(host)
    ops, labels = [], []  # heaps of (-start, end, name)
    i = 0
    for s, e in sorted(gap_list, key=lambda g: (g[0] + g[1]) / 2):
        mid = (s + e) / 2
        while i < len(host) and host[i][0] <= mid:
            hs, he, name = host[i]
            heapq.heappush(labels if name.startswith(LABEL) else ops, (-hs, he, name))
            i += 1
        innermost = []
        for heap in (labels, ops):
            # latest start first: drop the events that ended before this midpoint (and so before every
            # later one); the top is then the innermost event still open
            while heap and heap[0][1] < mid:
                heapq.heappop(heap)
            innermost.append(heap[0][2] if heap else None)
        label, op = innermost
        key = "/".join(x for x in (label, op) if x) or "idle host"
        out[key] += e - s
    return out


def top(d: dict[str, float], n: int = 10) -> list:
    return [[k, v] for k, v in sorted(d.items(), key=lambda kv: -kv[1])[:n]]
