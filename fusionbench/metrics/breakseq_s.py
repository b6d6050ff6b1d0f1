"""``breakseq_s``: mean seconds a library spends in ``pipeline.run``'s
breakseq stage (its index loads and a target's alignment each), from each
run's ``metrics.json`` ``stages``."""


def read(ctx):
    libs = ctx.libraries
    return sum(r["stages"]["breakseq"] for r in libs) / len(libs) \
        if libs else None
