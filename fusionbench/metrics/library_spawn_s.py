"""``library_spawn_s``: mean seconds a cohort library's process takes from
its spawn to the opening of its ``Tracer`` (the interpreter's start and
the imports): the program's span ``cohort.spawn``, which a library process
that ``defuse cohort`` started records (``program_spans.mean_seconds``);
nothing where the program records no such span."""

from program_spans import mean_seconds


def read(ctx):
    return mean_seconds(ctx, "cohort.spawn")
