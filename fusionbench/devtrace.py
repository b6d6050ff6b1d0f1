"""The device's side of a traced window: busy seconds (the union of kernel,
copy and set intervals), seconds and launches by operation name, and the
idle gaps named by the host ranges open over them.

Events are ``(name, on_device, start_us, end_us)`` on one clock: a ``run``
cell's from ``torch.profiler`` in the harness's process
(``profiler_events``), a ``cohort`` cell's from every library process's own
Chrome trace, each put on the epoch by its ``baseTimeNanoseconds``
(``chrome_events``).  Host ranges are the program's spans (``defuse:``) and
the harness's (``fusionbench:``, a ``run`` cell's ``library``)."""

from __future__ import annotations

import dataclasses
import heapq
import json
import pathlib

SPAN_PREFIX = "fusionbench:"
PROGRAM_PREFIX = "defuse:"
# Chrome trace categories of work on the card (what ``profiler_events``
# takes as CUDA, less the profiler's mirror of host ranges)
DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")
# ... and of host ranges: ``record_function``'s and the program's spans
HOST_CATS = ("user_annotation", "cpu_op")


@dataclasses.dataclass
class DeviceTrace:
    busy_s: float
    window_s: float
    kernels: dict[str, float]         # device seconds by operation name
    launches: dict[str, int]          # device operations by name
    gaps: list[tuple[str, float]]     # (range, idle seconds), longest first


def _union(intervals: list[tuple[float, float]]) -> list[tuple[float, float]]:
    out: list[list[float]] = []
    for s, e in sorted(intervals):
        if out and s <= out[-1][1]:
            out[-1][1] = max(out[-1][1], e)
        else:
            out.append([s, e])
    return [(s, e) for s, e in out]


def _is_range(name: str) -> bool:
    return name.startswith((PROGRAM_PREFIX, SPAN_PREFIX))


def _labelled(ranges, w0: float, w1: float) -> list[tuple[float, float, str]]:
    """The window cut at every range's edges, each piece named by the
    shortest program range open over it, in any process; where none is,
    by the shortest harness range; else ``between``.  Adjacent pieces of
    one name are joined."""
    ranked = sorted((s, e, (0 if n.startswith(PROGRAM_PREFIX) else 1,
                            e - s), n) for n, s, e in ranges if e > s)
    cuts = sorted({w0, w1} | {t for s, e, _, _ in ranked for t in (s, e)
                              if w0 < t < w1})
    open_: list = []             # (rank, length, end, name), lazily pruned
    out: list[list] = []
    i = 0
    for s, e in zip(cuts, cuts[1:]):
        while i < len(ranked) and ranked[i][0] <= s:
            _a, b, key, name = ranked[i]
            heapq.heappush(open_, (*key, b, name))
            i += 1
        while open_ and open_[0][2] <= s:
            heapq.heappop(open_)
        name = open_[0][3] if open_ else "between"
        if out and out[-1][2] == name:
            out[-1][1] = e
        else:
            out.append([s, e, name])
    return [tuple(p) for p in out]


def analyse(events, window: tuple[float, float]) -> DeviceTrace:
    """``events`` are ``(name, on_device, start_us, end_us)``; ``window`` is
    the traced window's start and end on the same clock.  Busy time is
    clipped to the window; time in no process's trace is idle."""
    w0, w1 = window
    device = [(s, e, n) for n, dev, s, e in events
              if dev and e > s and not _is_range(n)]
    ranges = [(n, s, e) for n, dev, s, e in events
              if not dev and _is_range(n) and n != SPAN_PREFIX + "window"]
    kernels: dict[str, float] = {}
    launches: dict[str, int] = {}
    for s, e, n in device:
        kernels[n] = kernels.get(n, 0.0) + (e - s) * 1e-6
        launches[n] = launches.get(n, 0) + 1
    busy = _union([(max(s, w0), min(e, w1)) for s, e, _ in device
                   if e > w0 and s < w1])
    idle, t = [], w0
    for s, e in busy + [(w1, w1)]:
        if s > t:
            idle.append((t, s))
        t = max(t, e)
    # each idle stretch cut at the ranges' edges, named by the range open
    gaps = []
    for a, b, name in _labelled(ranges, w0, w1):
        for s, e in idle:
            lo, hi = max(a, s), min(b, e)
            if hi > lo:
                gaps.append((name, (hi - lo) * 1e-6))
    gaps.sort(key=lambda g: -g[1])
    return DeviceTrace(sum(e - s for s, e in busy) * 1e-6, (w1 - w0) * 1e-6,
                       kernels, launches, gaps)


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


def chrome_events(path: pathlib.Path,
                  origin_ns: int) -> list[tuple[str, bool, float, float]]:
    """(name, on_device, start µs, end µs) of a Chrome trace's device
    operations and program ranges, in µs after ``origin_ns`` on the epoch
    (``time.time_ns``): each event at the trace's ``baseTimeNanoseconds``
    plus its ``ts``."""
    trace = json.loads(pathlib.Path(path).read_text())
    if "baseTimeNanoseconds" not in trace:
        raise ValueError(f"{path}: no baseTimeNanoseconds to place it by")
    shift = (int(trace["baseTimeNanoseconds"]) - origin_ns) / 1e3
    out = []
    for ev in trace.get("traceEvents", ()):
        if ev.get("ph") != "X":
            continue
        on_dev = ev.get("cat") in DEVICE_CATS
        if on_dev or (ev.get("cat") in HOST_CATS and
                      ev["name"].startswith(PROGRAM_PREFIX)):
            s = shift + float(ev["ts"])
            out.append((ev["name"], on_dev, s, s + float(ev.get("dur", 0))))
    return out


def tally(events) -> dict:
    """Launches and seconds of ``screen_kernel`` and of the copies
    (``Memcpy``) among ``events``' device operations."""
    out = {"screen_kernel": [0, 0.0], "copies": [0, 0.0]}
    for n, dev, s, e in events:
        key = "screen_kernel" if "screen_kernel" in n else \
            "copies" if "Memcpy" in n else None
        if dev and key and not _is_range(n):
            out[key][0] += 1
            out[key][1] += (e - s) * 1e-6
    return {k: {"launches": n, "seconds": s} for k, (n, s) in out.items()}
