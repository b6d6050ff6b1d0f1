"""The benchmark's own host spans around the program's layers, and the
window's resident-memory high-water mark.

``StageClock`` is a copy of ``chip_smoke.StageClock``: it wraps the
frontend (``align_reads``) and the Runner's stages while a ``run`` goes
through the command line, and opens a span of the same name in the
profiler's trace when one is recording, so that the device's idle gaps can
be laid against them.  The program's own stage seconds come from the
``metrics.json`` and ``metrics.discover.json`` that each run writes.
"""

from __future__ import annotations

import contextlib
import resource
import time

from devtrace import SPAN_PREFIX


class StageClock:
    """Wall seconds of the frontend and of the Runner's stages (read stats,
    covariance samples), and spans around the frontend and discover; the
    runner nests them in a span of the whole library, whose rest is the
    run's other stages (``devtrace.LABELS``)."""

    def __init__(self, traced: bool):
        self.traced = traced
        self.seconds: dict[str, float] = {}

    @contextlib.contextmanager
    def span(self, name: str):
        t0 = time.perf_counter()
        if self.traced:
            import torch
            ctx = torch.profiler.record_function(SPAN_PREFIX + name)
        else:
            ctx = contextlib.nullcontext()
        try:
            with ctx:
                yield
        finally:
            self.seconds[name] = self.seconds.get(name, 0.0) + \
                time.perf_counter() - t0

    def __enter__(self):
        from defuse_tpu_torch.align import frontend
        from defuse_tpu_torch.pipeline import run as run_module
        from defuse_tpu_torch.pipeline.runner import Runner
        self._saved = (frontend.align_reads, Runner.run,
                       run_module.discover_fusions)
        align_reads, runner_run, discover = self._saved
        clock = self

        def timed_align(*args, **kw):
            with clock.span("frontend"):
                return align_reads(*args, **kw)

        def timed_discover(**kw):
            with clock.span("discover"):
                return discover(**kw)

        def timed_run(runner, name, *args, **kw):
            t0 = time.perf_counter()
            try:
                return runner_run(runner, name, *args, **kw)
            finally:
                clock.seconds[name] = time.perf_counter() - t0

        frontend.align_reads, Runner.run = timed_align, timed_run
        run_module.discover_fusions = timed_discover
        return self

    def __exit__(self, *exc):
        from defuse_tpu_torch.align import frontend
        from defuse_tpu_torch.pipeline import run as run_module
        from defuse_tpu_torch.pipeline.runner import Runner
        (frontend.align_reads, Runner.run,
         run_module.discover_fusions) = self._saved


class RssPeak:
    """The process's resident high-water mark over the window
    (``getrusage``'s ``ru_maxrss``).  The mark is reset at the window's
    start (``/proc/self/clear_refs``, 5) where the kernel permits it
    (``reset``).  Where it does not, the mark is the process's, and reading
    ``/proc/self/statm`` on a thread instead slows the program under a
    sandboxing kernel (5-15 ms a read at this size); set-up's data work runs
    in a child process (``prepare.py``), so the mark at the window's start
    is the port's imports, kernels and 30,000-pair warm-up alone, which a
    million-pair library passes.  The peak is exact where the mark was
    reset or the window raised it (``exact``), and not read otherwise."""

    @staticmethod
    def mark() -> int:
        return resource.getrusage(resource.RUSAGE_SELF).ru_maxrss * 1024

    def __enter__(self):
        before = self.mark()
        try:
            with open("/proc/self/clear_refs", "w") as fh:
                fh.write("5")
        except OSError:
            pass
        self.start = self.mark()
        self.reset = self.start < before
        return self

    def __exit__(self, *exc):
        self.peak = self.mark()
        self.raised = self.peak > self.start
        self.exact = self.reset or self.raised
