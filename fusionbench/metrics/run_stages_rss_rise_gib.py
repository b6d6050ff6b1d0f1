"""``run_stages_rss_rise_gib``: the rise of the process's resident
high-water mark inside ``pipeline.run``'s host stages other than discover
(the spans ``read stats`` and ``covariance samples``, the stages
``pvalues``, ``breakseq``, ``annotation``, ``denovo`` and
``collate+classify``) over the window's libraries, summed, in GiB
(``program_memory.rise_gib``)."""

from program_memory import rise_gib

STAGES = ("read stats", "covariance samples", "pvalues", "breakseq",
          "annotation", "denovo", "collate+classify")


def read(ctx):
    return rise_gib(ctx, *STAGES)
