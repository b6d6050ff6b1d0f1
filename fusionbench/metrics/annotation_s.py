"""``annotation_s``: mean seconds a library spends in ``pipeline.run``'s
annotation stage, from each run's ``metrics.json`` ``stages``."""


def read(ctx):
    libs = ctx.libraries
    return sum(r["stages"]["annotation"] for r in libs) / len(libs) \
        if libs else None
