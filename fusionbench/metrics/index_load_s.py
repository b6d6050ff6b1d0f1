"""``index_load_s``: mean seconds a library spends loading seed indices:
the frontend's (span ``frontend.index_load``: cdna, genome, rRNA,
prefilter) and breakseq's (span ``breakseq.index_load``)."""

from program_spans import mean_seconds


def read(ctx):
    return mean_seconds(ctx, "frontend.index_load", "breakseq.index_load")
