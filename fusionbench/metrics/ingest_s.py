"""``ingest_s``: mean seconds a library spends in the frontend's FASTQ
ingest (the program's span ``frontend.ingest``)."""

from program_spans import mean_seconds


def read(ctx):
    return mean_seconds(ctx, "frontend.ingest")
