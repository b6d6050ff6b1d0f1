"""The program's own spans, as the per-layer readers of ``metrics/`` read
them.  A library run in another process (a ``cohort`` cell) carries its
span seconds in its record (``spans``, from its ``metrics.json``, which the
same ``Tracer`` writes; None where it records none).  A ``run`` in this
process leaves a dict of span name to seconds in
``defuse_tpu_torch.utils.profiling.RUN_SPANS``, read here (its record
carries no ``spans``); the window's libraries are the last
``len(ctx.libraries)`` entries: runs that failed leave none, and no run
follows the window."""


def mean_seconds(ctx, *names):
    """Mean over the window's libraries of the seconds of the spans
    ``names``, summed; None where the program keeps no such record (a
    program without spans), fewer records than libraries, or none of the
    spans."""
    n = len(ctx.libraries)
    if n and all("spans" in r for r in ctx.libraries):
        runs = [r["spans"] for r in ctx.libraries]
        if None in runs:
            return None
    else:
        try:
            from defuse_tpu_torch.utils.profiling import RUN_SPANS
        except ImportError:
            return None
        runs = list(RUN_SPANS)[-n:] if n else []
    if not n or len(runs) < n or \
            not any(name in r for r in runs for name in names):
        return None
    return sum(r.get(name, 0.0) for r in runs for name in names) / n
