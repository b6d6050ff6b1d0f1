"""``run_stages_s``: mean seconds a library spends in ``pipeline.run``'s
host stages other than discover (read stats and covariance samples by the
program's spans around the Runner's calls of those names; p-values,
breakseq, annotation, de novo, collate and classify from each run's
``metrics.json`` ``stages``; ``cohort.library_record``); nothing where
a library has no such reading."""


def read(ctx):
    values = [r["run_stages_s"] for r in ctx.libraries]
    if not values or None in values:
        return None
    return sum(values) / len(values)
