"""``align_job_s``: mean seconds a library spends in the frontend's
``align_job`` (span ``frontend.align_job``, summed over its shards)."""

from program_spans import mean_seconds


def read(ctx):
    return mean_seconds(ctx, "frontend.align_job")
