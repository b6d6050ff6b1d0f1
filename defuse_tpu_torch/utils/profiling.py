"""Stage metrics, kernel timing and opt-in device profiling for the port.

``Tracer`` records stage wall times and counters into the run's metrics
artifact (the port's copy of ``defuse_tpu/utils/profiling.Tracer``);
``device_trace`` is the counterpart of that module's ``device_trace`` on
``torch.profiler``; ``cuda_time_ms`` times a kernel by CUDA events.
"""

from __future__ import annotations

import contextlib
import json
import os
import pathlib
import time

import torch


class Tracer:
    """Stage wall-clock + counter collector with a JSON artifact."""

    def __init__(self, outdir: str | None = None,
                 artifact: str = "metrics.json"):
        self._t0 = time.time()
        self._last = self._t0
        self.stages: list[dict] = []
        self.counters: dict[str, float] = {}
        self._path = (pathlib.Path(outdir) / artifact) if outdir else None
        self._echo = bool(os.environ.get("DEFUSE_STAGE_TIMING"))

    def mark(self, stage: str, **extra) -> float:
        """Close the current stage interval under ``stage``."""
        now = time.time()
        dt = now - self._last
        self._last = now
        rec = {"stage": stage, "seconds": round(dt, 4)}
        if extra:
            rec.update(extra)
        self.stages.append(rec)
        if self._echo:
            print(f"[stage] {stage}: {dt:.2f}s", flush=True)
        return dt

    def count(self, name: str, value: float) -> None:
        self.counters[name] = self.counters.get(name, 0) + value

    def flush(self) -> str | None:
        if self._path is None:
            return None
        self._path.parent.mkdir(parents=True, exist_ok=True)
        payload = {
            "total_seconds": round(time.time() - self._t0, 4),
            "stages": self.stages,
            "counters": self.counters,
        }
        tmp = self._path.with_name(self._path.name + ".tmp")
        tmp.write_text(json.dumps(payload, indent=1))
        tmp.replace(self._path)
        return str(self._path)


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


@contextlib.contextmanager
def device_trace(label: str):
    """Wrap a device-heavy stage in ``torch.profiler`` when
    ``DEFUSE_TORCH_PROFILE=<dir>`` is set: a Chrome trace and a per-kernel
    table land in ``<dir>/<label>/``.  No-op otherwise."""
    trace_dir = os.environ.get("DEFUSE_TORCH_PROFILE")
    if not trace_dir:
        yield
        return
    from torch.profiler import ProfilerActivity, profile

    path = pathlib.Path(trace_dir) / label
    path.mkdir(parents=True, exist_ok=True)
    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    with profile(activities=activities) as prof:
        yield
    prof.export_chrome_trace(str(path / "trace.json"))
    (path / "kernels.txt").write_text(
        prof.key_averages().table(sort_by="self_device_time_total"
                                  if torch.cuda.is_available()
                                  else "self_cpu_time_total", row_limit=30))
