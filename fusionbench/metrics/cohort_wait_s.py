"""``cohort_wait_s``: mean seconds a cohort library waits for a free
worker slot, from the ``defuse cohort`` call's start to its process's
spawn: the program's span ``cohort.wait``, which a library process that
the cohort started records (``program_spans.mean_seconds``); nothing where
the program records no such span."""

from program_spans import mean_seconds


def read(ctx):
    return mean_seconds(ctx, "cohort.wait")
