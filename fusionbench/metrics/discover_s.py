"""``discover_s``: mean seconds a library spends in discover
(``pipeline.discover``), from each run's ``metrics.discover.json``
``total_seconds``."""


def read(ctx):
    libs = ctx.libraries
    return sum(r["discover_s"] for r in libs) / len(libs) if libs else None
