"""The program's own spans, as the per-layer readers of ``metrics/`` read
them: each finished ``defuse run`` leaves a dict of span name to seconds
in ``defuse_tpu_torch.utils.profiling.RUN_SPANS``, read in this process
(``metrics.json`` is not read: ``run_stages_s`` sums its ``stages``).  The
window's libraries are the last ``len(ctx.libraries)`` entries: runs
that failed leave none, and no run follows the window."""


def mean_seconds(ctx, *names):
    """Mean over the window's libraries of the seconds of the spans
    ``names``, summed; None where the program keeps no such record (a
    program without spans), fewer records than libraries, or none of the
    spans."""
    try:
        from defuse_tpu_torch.utils.profiling import RUN_SPANS
    except ImportError:
        return None
    n = len(ctx.libraries)
    runs = list(RUN_SPANS)[-n:] if n else []
    if not n or len(runs) < n or \
            not any(name in r for r in runs for name in names):
        return None
    return sum(r.get(name, 0.0) for r in runs for name in names) / n
