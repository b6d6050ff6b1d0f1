"""Spans, stage metrics, process memory, kernel timing and device profiling
for the port.

``Tracer`` records a library's spans, each with the process's resident
high-water mark at its edges, and the stage wall times and counters of a
metrics artifact; ``library`` opens the Tracer of one ``run`` (with
``torch.profiler`` over it under ``DEFUSE_TORCH_PROFILE``), which every
layer below reaches through ``current``; ``RUN_SPANS`` and ``RUN_MEMORY``
keep each finished run's span seconds and memory record for readers in the
same process; ``process_span`` records the process's start
(``PROCESS_SPANS``), and a library process that ``defuse cohort`` started
also its time in the cohort's queue and its start (``cohort.wait``,
``cohort.spawn``); ``cuda_time_ms`` times a kernel by CUDA events.
"""

from __future__ import annotations

import collections
import contextlib
import functools
import itertools
import json
import os
import pathlib
import resource
import time
import uuid

import torch

SPAN_PREFIX = "defuse:"
# one dict a finished run (``library``): span name -> seconds summed
RUN_SPANS: collections.deque = collections.deque(maxlen=1024)
# one dict a finished run (``library``): the mark at its entry (``start``)
# and exit (``end``), and span name -> the rise of the mark in bytes,
# summed (``rise``)
RUN_MEMORY: collections.deque = collections.deque(maxlen=1024)
# the process's start, a record a span (``process_span``), as they closed
PROCESS_SPANS: list[dict] = []
_PROCESS_NAMES: set[str] = set()   # the process spans opened so far
_process_written = 0               # those a metrics.json carries
_LIBRARIES: list[Tracer] = []   # the open libraries' Tracers, innermost last


def rss_hwm() -> int:
    """The process's resident high-water mark in bytes (``getrusage``'s
    ``ru_maxrss``): a system call, 3-5 µs on the H100's host."""
    return resource.getrusage(resource.RUSAGE_SELF).ru_maxrss * 1024


def _profiler_on() -> bool:
    return torch._C._autograd._profiler_enabled()


class Tracer:
    """A library's spans, and one artifact's stage wall clock and counters.

    A span (``span``, ``stage``) is a stretch of the run on
    ``time.perf_counter_ns`` (CLOCK_MONOTONIC, the clock of the native
    library's ``steady_clock``) with its name, the span open around it (its
    parent), the run's identifier and counts taken at its edges: the
    process's resident high-water mark at its exit (``rss_hwm``, bytes)
    and its rise over the span (``rss_hwm_rise``), which is 0 unless the
    span set a new peak (the program never resets the mark).  While
    ``torch.profiler`` records, each span opened here is also a range
    ``defuse:<name>`` of the profiler's host events, on its clock (a
    function-scope record, which the profiler does not mirror onto the
    device's timeline as it does ``record_function``'s, so a device trace's
    busy time stays the kernels' and copies'); otherwise a span costs two
    clock reads and an append.  Stages follow
    one another, each a span open until the next, and each closed stage
    also lands in ``stages``.  ``part`` gives a layer a stage log, counters
    and an artifact of its own on the same spans.  Spans are opened and
    closed by the thread that runs the library."""

    def __init__(self, outdir: str | None = None,
                 artifact: str = "metrics.json", *,
                 within: Tracer | None = None):
        self._root = self if within is None else within._root
        if within is None:
            self.run_id = uuid.uuid4().hex
            # [id, name, parent id, start ns, end ns, counts]
            self.spans: list[list] = []
            # the open spans, innermost last, each with its profiler range
            # last until it closes
            self._open: list[list] = []
            self._ids = itertools.count()
            self._echo = bool(os.environ.get("DEFUSE_STAGE_TIMING"))
        self._t0 = self._t1 = time.perf_counter_ns()
        self._stage = None                # the open stage's span id
        self.stages: list[dict] = []
        self.counters: dict[str, float] = {}
        self._path = (pathlib.Path(outdir) / artifact) if outdir else None
        self.memory: dict | None = None   # a library's (``library``)

    def part(self, outdir: str, artifact: str) -> Tracer:
        """A Tracer of its own stages, counters and artifact whose spans
        are this one's."""
        return Tracer(outdir, artifact, within=self)

    @contextlib.contextmanager
    def span(self, name: str, **counts):
        """A span around the block; ``counts`` is yielded, so the block can
        add the counts it learns."""
        root = self._root
        sid = root._enter(name, counts)
        try:
            yield counts
        finally:
            root._exit(sid)

    def stage(self, name: str | None) -> None:
        """Close this Tracer's open stage, recording it under ``stages``,
        and open stage ``name`` (none when None), which starts at the clock
        and the mark its predecessor ended at: stages abut."""
        root = self._root
        edge = None
        if self._stage is not None:
            _sid, done, _p, start, end, counts = root._exit(self._stage)
            self.stages.append({"stage": done,
                                "seconds": round((end - start) / 1e9, 4)})
            self._t1 = end
            self._stage = None
            edge = end, counts["rss_hwm"]
        if name is not None:
            self._stage = root._enter(name, {}, edge)
            if not self.stages:
                self._t0 = root._open[-1][3]

    def count(self, name: str, value: float) -> None:
        self.counters[name] = self.counters.get(name, 0) + value

    def record(self, name: str, start: int, end: int) -> None:
        """A closed span ``name`` from ``start`` to ``end`` on the spans'
        clock at the top of the span tree, for a stretch that passed before
        this Tracer opened; it carries no mark."""
        root = self._root
        root.spans.append([next(root._ids), name, None, start, end, {}])

    def _enter(self, name: str, counts: dict,
               edge: tuple[int, int] | None = None) -> int:
        """Open span ``name`` at ``edge`` (its clock and mark), else now."""
        rf = None
        if _profiler_on():
            rf = torch._C._profiler._RecordFunctionFast(SPAN_PREFIX + name)
            rf.__enter__()
        sid = next(self._ids)
        if edge is None:
            counts["rss_hwm"] = rss_hwm()     # the entry's, until the exit
            start = time.perf_counter_ns()
        else:
            start, counts["rss_hwm"] = edge
        self._open.append([sid, name, self._open[-1][0] if self._open
                           else None, start, None, counts, rf])
        return sid

    def _exit(self, sid: int) -> list:
        """Close span ``sid`` and any left open inside it."""
        end = time.perf_counter_ns()
        mark = rss_hwm()
        while self._open:
            rec = self._open.pop()
            rec[4] = end
            counts = rec[5]
            counts["rss_hwm_rise"] = mark - counts["rss_hwm"]
            counts["rss_hwm"] = mark
            rf = rec.pop()
            if rf is not None:
                rf.__exit__(None, None, None)
            self.spans.append(rec)
            if self._echo:
                print(f"[stage] {rec[1]}: {(end - rec[3]) / 1e9:.2f}s",
                      flush=True)
            if rec[0] == sid:
                return rec
        raise RuntimeError(f"span {sid} is not open")

    def span_records(self) -> list[dict]:
        """The closed spans in the order they started, each with its
        seconds and its self seconds (its time less the part of it its
        children cover)."""
        kids: dict[int, list] = collections.defaultdict(list)
        for rec in self.spans:
            if rec[2] is not None:
                kids[rec[2]].append((rec[3], rec[4]))
        out = []
        for sid, name, parent, start, end, counts in sorted(
                self.spans, key=lambda r: (r[3], r[0])):
            covered, reach = 0, start
            for a, b in sorted(kids[sid]):
                a, b = max(a, reach), min(b, end)
                if b > a:
                    covered += b - a
                    reach = b
            out.append({"name": name, "id": sid, "parent": parent,
                        "run": self.run_id, "start_ns": start,
                        "end_ns": end, "seconds": round((end - start) / 1e9,
                                                        6),
                        "self_seconds": round((end - start - covered) / 1e9,
                                              6),
                        "counts": counts})
        return out

    def span_seconds(self) -> dict[str, float]:
        """Seconds of each span name, summed over the run."""
        out: dict[str, float] = {}
        for rec in self.spans:
            out[rec[1]] = out.get(rec[1], 0.0) + (rec[4] - rec[3]) / 1e9
        return out

    def span_rises(self) -> dict[str, int]:
        """The rise of the resident high-water mark in each span name's
        spans, in bytes, summed over the run."""
        out: dict[str, int] = {}
        for rec in self.spans:
            if "rss_hwm_rise" in rec[5]:
                out[rec[1]] = out.get(rec[1], 0) + rec[5]["rss_hwm_rise"]
        return out

    def flush(self) -> str | None:
        if self._path is None:
            return None
        self._path.parent.mkdir(parents=True, exist_ok=True)
        t1 = time.perf_counter_ns() if self._stage is not None or \
            not self.stages else self._t1
        payload = {
            "total_seconds": round((t1 - self._t0) / 1e9, 4),
            "stages": self.stages,
            "counters": self.counters,
        }
        if self._root is self:
            global _process_written
            payload["spans"] = self.span_records()
            if self.memory is not None:
                payload["memory"] = self.memory
            if len(PROCESS_SPANS) > _process_written:
                payload["process_spans"] = PROCESS_SPANS[_process_written:]
                _process_written = len(PROCESS_SPANS)
        tmp = self._path.with_name(self._path.name + ".tmp")
        tmp.write_text(json.dumps(payload, indent=1))
        tmp.replace(self._path)
        return str(self._path)


def current() -> Tracer:
    """The Tracer of the library being run (``library``); where none is
    open, a new one that writes nothing."""
    return _LIBRARIES[-1] if _LIBRARIES else Tracer()


@contextlib.contextmanager
def library(outdir: str):
    """The Tracer of one library's run into ``outdir``, ``current`` while
    open; opened again for the same ``outdir``, the one already open.  On
    a clean exit its ``metrics.json`` is written, with its ``memory`` (the
    ``RUN_MEMORY`` record) and the process spans that no earlier
    ``metrics.json`` of the process carried (``process_spans``), and its
    span seconds and memory record are added to ``RUN_SPANS`` and
    ``RUN_MEMORY``.  Under ``DEFUSE_TORCH_PROFILE=<dir>``,
    ``torch.profiler`` records the whole run: a Chrome trace, with a
    ``defuse:`` range for every span, and a kernel table land in
    ``<dir>/<run id>/``."""
    path = pathlib.Path(outdir) / "metrics.json"
    if _LIBRARIES and _LIBRARIES[-1]._path == path:
        yield _LIBRARIES[-1]
        return
    tracer = Tracer(outdir)
    _cohort_start(tracer)
    start = {"rss_hwm": rss_hwm()}
    trace_dir = os.environ.get("DEFUSE_TORCH_PROFILE")
    profiled = _profiled(pathlib.Path(trace_dir) / tracer.run_id) \
        if trace_dir else contextlib.nullcontext()
    _LIBRARIES.append(tracer)
    try:
        with profiled:
            try:
                yield tracer
            finally:
                if tracer._open:        # a failed run's
                    tracer._exit(tracer._open[0][0])
                end = {"rss_hwm": rss_hwm()}
    finally:
        _LIBRARIES.remove(tracer)
    tracer.memory = {"start": start, "end": end,
                     "rise": tracer.span_rises()}
    tracer.flush()
    RUN_SPANS.append(tracer.span_seconds())
    RUN_MEMORY.append(tracer.memory)


def _cohort_start(tracer: Tracer) -> None:
    """Where ``defuse cohort`` started this process (its environment holds
    ``pipeline.cohort.COHORT_ENV``, taken out here, so once a process): the
    spans ``cohort.wait``, from the call's start to this process's spawn
    (the library's time in the cohort's queue), and ``cohort.spawn``, from
    the spawn to the opening of ``tracer`` (the interpreter's start and the
    imports), and the counters ``cohort_workers`` (the library processes
    the cohort runs at once), ``cpus`` (the CPU affinity set's size, the
    native stages' threads) and ``torch_threads``."""
    from ..pipeline.cohort import COHORT_ENV
    if not all(k in os.environ for k in COHORT_ENV):
        return
    start, spawn, workers = (int(os.environ.pop(k)) for k in COHORT_ENV)
    from ..cluster.native import _default_threads
    tracer.record("cohort.wait", start, spawn)
    tracer.record("cohort.spawn", spawn, tracer._t0)
    tracer.count("cohort_workers", workers)
    tracer.count("cpus", _default_threads())
    tracer.count("torch_threads", torch.get_num_threads())


@contextlib.contextmanager
def process_span(name: str):
    """A span of the process's start, once a process, on the spans' clock:
    the first time ``name`` opens, its record lands in ``PROCESS_SPANS``
    with the mark at its exit and its rise, and it yields True; every later
    time it records nothing and yields False.  It stays out of the
    library's span tree, which only the thread that runs the library may
    touch."""
    if name in _PROCESS_NAMES:
        yield False
        return
    _PROCESS_NAMES.add(name)
    mark, start = rss_hwm(), time.perf_counter_ns()
    yield True
    end, rise = time.perf_counter_ns(), rss_hwm() - mark
    PROCESS_SPANS.append(_process_record(
        name, start, end, {"rss_hwm": mark + rise, "rss_hwm_rise": rise}))


def _process_record(name: str, start: int, end: int, counts: dict) -> dict:
    return {"name": name, "start_ns": start, "end_ns": end,
            "seconds": round((end - start) / 1e9, 6), "counts": counts}


def _imported() -> None:
    """Close ``process.import``: from the package's first line to the end
    of this module's first import, ``torch``'s included unless the program
    had loaded it before the package (``torch_preloaded``)."""
    import defuse_tpu_torch as package
    end, mark = time.perf_counter_ns(), rss_hwm()
    _PROCESS_NAMES.add("process.import")
    PROCESS_SPANS.append(_process_record(
        "process.import", package._START_NS, end,
        {"rss_hwm": mark, "rss_hwm_rise": mark - package._START_RSS_HWM,
         "torch_preloaded": int(package._TORCH_PRELOADED)}))


def runs_library(fn):
    """``fn``, called with keywords, as the library of its ``output_dir``
    (``library``)."""
    @functools.wraps(fn)
    def run(**kwargs):
        with library(kwargs["output_dir"]):
            return fn(**kwargs)
    return run


@contextlib.contextmanager
def _profiled(path: pathlib.Path):
    """``torch.profiler`` (CPU and CUDA activity) over the block, unless
    one records already, whose trace then holds the spans."""
    if _profiler_on():
        yield
        return
    from torch.profiler import ProfilerActivity, profile

    cuda = torch.cuda.is_available()
    activities = [ProfilerActivity.CPU] + \
        ([ProfilerActivity.CUDA] if cuda else [])
    with profile(activities=activities) as prof:
        yield
    path.mkdir(parents=True, exist_ok=True)
    prof.export_chrome_trace(str(path / "trace.json"))
    (path / "kernels.txt").write_text(prof.key_averages().table(
        sort_by="self_device_time_total" if cuda else "self_cpu_time_total",
        row_limit=30))


def cuda_time_ms(fn, reps: int, graph: bool = False, rounds: int = 1) -> float:
    """Mean milliseconds of ``fn()`` over ``reps`` runs on the current CUDA
    stream, by CUDA events, after one warm-up run; the least of ``rounds``
    such means.

    ``graph`` captures the ``reps`` runs in one CUDA graph and times its
    replay, so the host's per-launch cost leaves no gaps between them:
    for kernels that finish in less time than the host takes to launch
    them."""
    fn()
    torch.cuda.synchronize()
    run = fn
    if graph:
        g = torch.cuda.CUDAGraph()
        with torch.cuda.graph(g):
            for _ in range(reps):
                fn()
        g.replay()
        torch.cuda.synchronize()
        run = g.replay
    best = float("inf")
    for _ in range(rounds):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(1 if graph else reps):
            run()
        end.record()
        torch.cuda.synchronize()
        best = min(best, start.elapsed_time(end) / reps)
    return best


_imported()
