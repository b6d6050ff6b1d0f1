"""Kernel timing and opt-in device profiling for the port.

``device_trace`` is the counterpart of
``defuse_tpu/utils/profiling.device_trace`` on ``torch.profiler``;
``cuda_time_ms`` times a kernel by CUDA events.  Stage wall times and
counters stay with the shared ``defuse_tpu.utils.profiling.Tracer``.
"""

from __future__ import annotations

import contextlib
import os
import pathlib

import torch


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
