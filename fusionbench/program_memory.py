"""The program's records of the process's resident high-water mark, as the
per-layer readers of ``metrics/`` read them, in GiB.  A ``run`` in this
process leaves its process-start spans in
``defuse_tpu_torch.utils.profiling.PROCESS_SPANS`` (each with its counts:
``rss_hwm``, the mark at its exit, and ``rss_hwm_rise``) and a record a
finished library in ``profiling.RUN_MEMORY`` (the mark at its entry,
``start``, and the rise of the mark summed by span name, ``rise``); the
window's libraries are the last ``len(ctx.libraries)`` records, as
``program_spans`` reads ``RUN_SPANS``.  A library run in another process
(a ``cohort`` cell, whose records carry ``spans``) leaves these in its
``metrics.json``, which the harness does not keep: nothing is read there,
nor from a program without the records."""

GIB = 2 ** 30


def _profiling(ctx):
    """The program's span module where the window's libraries ran in this
    process; None otherwise."""
    libs = ctx.libraries
    if not libs or any("spans" in r for r in libs):
        return None
    try:
        from defuse_tpu_torch.utils import profiling
    except ImportError:
        return None
    return profiling


def process_counts(ctx):
    """Span name -> counts of the process's start; None where there is no
    such record."""
    profiling = _profiling(ctx)
    spans = getattr(profiling, "PROCESS_SPANS", None)
    if spans is None:
        return None
    return {s["name"]: s["counts"] for s in spans}


def window_runs(ctx):
    """The window's libraries' memory records; None where there are fewer
    records than libraries, or none."""
    profiling = _profiling(ctx)
    records = getattr(profiling, "RUN_MEMORY", None)
    if records is None:
        return None
    n = len(ctx.libraries)
    runs = list(records)[-n:]
    return runs if len(runs) == n else None


def rise_gib(ctx, *names):
    """The rise of the mark inside the spans ``names`` over the window's
    libraries, summed; None where no record has any of them."""
    runs = window_runs(ctx)
    if runs is None or not any(n in r["rise"] for r in runs for n in names):
        return None
    return sum(r["rise"].get(n, 0) for r in runs for n in names) / GIB
