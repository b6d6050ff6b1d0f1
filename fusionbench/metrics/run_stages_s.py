"""``run_stages_s``: mean seconds a library spends in ``pipeline.run``'s
host stages other than discover (read stats and covariance samples by the
benchmark's span; p-values, breakseq, annotation, de novo, collate and
classify from each run's ``metrics.json``)."""


def read(ctx):
    libs = ctx.libraries
    return sum(r["run_stages_s"] for r in libs) / len(libs) if libs else None
