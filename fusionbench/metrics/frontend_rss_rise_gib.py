"""``frontend_rss_rise_gib``: the rise of the process's resident
high-water mark inside the program's span ``frontend`` (around
``align.frontend.align_reads``) over the window's libraries, summed, in
GiB (``program_memory.rise_gib``)."""

from program_memory import rise_gib


def read(ctx):
    return rise_gib(ctx, "frontend")
