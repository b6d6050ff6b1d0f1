"""``start_rss_gib``: the process's resident high-water mark at the entry
of the window's first library (the program's ``utils.profiling.library``),
in GiB: what the window starts from, the harness's ``[window]`` start mark
and whatever the harness does between it and the first library."""

from program_memory import GIB, window_runs


def read(ctx):
    runs = window_runs(ctx)
    return None if not runs else runs[0]["start"]["rss_hwm"] / GIB
