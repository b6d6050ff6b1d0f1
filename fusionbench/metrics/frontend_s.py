"""``frontend_s``: mean seconds a library spends in the aligner frontend
(``align.frontend.align_reads``): the program's span ``frontend`` around
it, in both verbs (``program_spans.mean_seconds``)."""

from program_spans import mean_seconds


def read(ctx):
    return mean_seconds(ctx, "frontend")
