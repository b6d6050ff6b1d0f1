"""``frontend_s``: mean seconds a library spends in the aligner frontend
(``align.frontend.align_reads``), by the benchmark's own span."""


def read(ctx):
    libs = ctx.libraries
    return sum(r["frontend_s"] for r in libs) / len(libs) if libs else None
