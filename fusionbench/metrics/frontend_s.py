"""``frontend_s``: mean seconds a library spends in the aligner frontend
(``align.frontend.align_reads``): the benchmark's own span around it in a
``run`` cell, the program's span ``frontend`` around the same call in a
``cohort`` cell; nothing where a library has neither."""


def read(ctx):
    values = [r["frontend_s"] for r in ctx.libraries]
    if not values or None in values:
        return None
    return sum(values) / len(values)
