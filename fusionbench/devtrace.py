"""The device's side of a traced window, from ``torch.profiler``'s events:
busy seconds (the union of kernel, copy and set intervals), kernel seconds
by name, and the idle gaps laid against the benchmark's host spans."""

from __future__ import annotations

import dataclasses

SPAN_PREFIX = "fusionbench:"
# a library's span, where neither the frontend's nor discover's is open
LABELS = {"library": "run_stages"}


@dataclasses.dataclass
class DeviceTrace:
    busy_s: float
    window_s: float
    kernels: dict[str, float]         # device seconds by operation name
    gaps: list[tuple[str, float]]     # (host span, idle seconds), longest first


def _union(intervals: list[tuple[float, float]]) -> list[tuple[float, float]]:
    out: list[list[float]] = []
    for s, e in sorted(intervals):
        if out and s <= out[-1][1]:
            out[-1][1] = max(out[-1][1], e)
        else:
            out.append([s, e])
    return [(s, e) for s, e in out]


def _labelled(spans, w0: float, w1: float) -> list[tuple[float, float, str]]:
    """The window cut into intervals, each named by the innermost benchmark
    span open over it (``between`` where none is)."""
    cuts = sorted({w0, w1} | {t for _, s, e in spans for t in (s, e)
                              if w0 < t < w1})
    out = []
    for s, e in zip(cuts, cuts[1:]):
        mid, best = (s + e) / 2, None
        for name, a, b in spans:
            if a <= mid <= b and (best is None or b - a < best[1]):
                best = (name, b - a)
        name = best[0] if best else "between"
        out.append((s, e, LABELS.get(name, name)))
    return out


def analyse(events, window: tuple[float, float]) -> DeviceTrace:
    """``events`` are ``(name, on_device, start_us, end_us)``; ``window`` is
    the traced window's start and end on the same clock."""
    w0, w1 = window
    device = [(s, e, n) for n, dev, s, e in events
              if dev and e > s and not n.startswith(SPAN_PREFIX)]
    spans = [(n[len(SPAN_PREFIX):], s, e) for n, dev, s, e in events
             if not dev and n.startswith(SPAN_PREFIX)
             and n != SPAN_PREFIX + "window"]
    kernels: dict[str, float] = {}
    for s, e, n in device:
        kernels[n] = kernels.get(n, 0.0) + (e - s) * 1e-6
    busy = _union([(max(s, w0), min(e, w1)) for s, e, _ in device
                   if e > w0 and s < w1])
    idle, t = [], w0
    for s, e in busy + [(w1, w1)]:
        if s > t:
            idle.append((t, s))
        t = max(t, e)
    # each idle gap cut at the host spans' edges, named by the span open
    gaps = []
    for a, b, name in _labelled(spans, w0, w1):
        for s, e in idle:
            lo, hi = max(a, s), min(b, e)
            if hi > lo:
                gaps.append((name, (hi - lo) * 1e-6))
    gaps.sort(key=lambda g: -g[1])
    return DeviceTrace(sum(e - s for s, e in busy) * 1e-6, (w1 - w0) * 1e-6,
                       kernels, gaps)


def profiler_events(prof) -> list[tuple[str, bool, float, float]]:
    """(name, on_device, start µs, end µs) of every event of a finished
    ``torch.profiler.profile``."""
    from torch.autograd import DeviceType
    out = []
    for ev in prof.events():
        on_dev = ev.device_type == DeviceType.CUDA
        tr = ev.time_range
        out.append((ev.name, on_dev, float(tr.start), float(tr.end)))
    return out
