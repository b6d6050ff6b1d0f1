"""The benchmark's own host spans in a traced ``run`` window (the window
and each library), and the window's resident-memory high-water mark.

The layers inside a library are timed by the program's own spans
(``metrics.json``, ``profiling.RUN_SPANS``); the harness's spans only
bound the window and name the idle gaps that no program span covers.
"""

from __future__ import annotations

import contextlib
import resource

from devtrace import SPAN_PREFIX


def span(name: str, traced: bool):
    """A range ``fusionbench:<name>`` in the profiler's trace around the
    block where the window is traced; nothing otherwise."""
    if not traced:
        return contextlib.nullcontext()
    import torch
    return torch.profiler.record_function(SPAN_PREFIX + name)


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
