"""Opt-in device profiling for the port.

Counterpart of ``defuse_tpu/utils/profiling.device_trace`` on
``torch.profiler``.  Stage wall times and counters stay with the shared
``defuse_tpu.utils.profiling.Tracer``.
"""

from __future__ import annotations

import contextlib
import os
import pathlib

import torch


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
