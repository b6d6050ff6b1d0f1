"""``import_rss_gib``: the process's resident high-water mark at the exit
of the program's span ``process.import`` (from the package's first line to
the end of the span system's import: ``torch``, NumPy and the port
imported; in a ``run`` cell the harness had imported ``torch``, and the
span's ``torch_preloaded`` says so), in GiB."""

from program_memory import GIB, process_counts


def read(ctx):
    spans = process_counts(ctx)
    if not spans or "process.import" not in spans:
        return None
    return spans["process.import"]["rss_hwm"] / GIB
