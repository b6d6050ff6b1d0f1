"""Standalone mate-anchored realignment — the ``tools/matealign.cpp``
equivalent (built but not invoked by the reference 0.8 pipeline; exposed
for API completeness).

For each read whose mate aligned, locally align the read against
``search_length`` bases of reference downstream of the mate (reverse
complemented for plus-strand mates), reporting
(fragment, score, percent-of-perfect) rows above a threshold
(``matealign.cpp:179-223``).
"""

from __future__ import annotations

from ..core.types import revcomp
from ..io.fasta import FastaStore
from .sw import _cxx_double, simple_align_score


def matealign(mate_alignments, reads, reference: FastaStore, *,
              search_length: int, match: int, mismatch: int, gap: int,
              threshold: float):
    """mate_alignments: {(fragment, read_end): [(ref_name, strand, pos)]}
    where pos is the strand-facing anchor (start on +, end on -);
    reads: iterable of (fragment, read_end, sequence).
    Yields output rows."""
    for fragment, read_end, sequence in reads:
        other = (fragment, 1 - read_end)
        for (ref_name, strand, pos) in mate_alignments.get(other, ()):
            if strand == 0:
                ref_seq, _, _ = reference.get(ref_name, 0, pos,
                                              search_length + 1)
                ref_seq = revcomp(ref_seq)
            else:
                ref_seq, _, _ = reference.get(ref_name, 0,
                                              pos - search_length,
                                              search_length + 1)
            score = simple_align_score(ref_seq, sequence, match, mismatch,
                                       gap)
            max_score = len(sequence) * match
            percent = score / max_score
            if percent < threshold:
                continue
            yield f"{fragment}\t{score}\t{_cxx_double(percent)}"
