"""``cuda_start_rss_gib``: the rise of the process's resident high-water
mark over the program's process-start spans on the card, summed, in GiB:
``process.cuda_context`` (the primary context, made in
``core/devices.require_cuda``) and each ``process.bind.<name>`` (the
first load of a kernel library, ``ops/_build.load``).  Under CUDA's lazy
module loading a kernel's code loads at its first launch, in its caller's
span, so it is not counted here."""

from program_memory import GIB, process_counts


def read(ctx):
    spans = process_counts(ctx)
    if not spans:
        return None
    rises = [c["rss_hwm_rise"] for n, c in spans.items()
             if n == "process.cuda_context" or n.startswith("process.bind.")]
    return sum(rises) / GIB if rises else None
