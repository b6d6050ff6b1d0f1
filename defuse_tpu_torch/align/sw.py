"""Local alignment (Smith-Waterman-like) — the ``localalign`` equivalent.

The reference's ``SimpleAligner`` (``tools/SimpleAligner.cpp:23-63``) fills
a global-ish matrix (row 0 = 0, column 0 accumulates gaps, no clamping)
and returns the maximum interior cell, used by the pipeline to kill
clusters whose paired reads align concordantly to one locus
(match 10, mismatch -5, gap -5, threshold 0.8, ``defuse_run.pl:489-505``).

Row-vectorized like ``align/split_dp.py``; integer-exact.
"""

from __future__ import annotations

import numpy as np


def simple_align_score(reference: str, sequence: str, match: int,
                       mismatch: int, gap: int) -> int:
    """Max interior DP cell (``SimpleAligner::Align``)."""
    r = np.frombuffer(reference.encode(), dtype=np.uint8)
    q = np.frombuffer(sequence.encode(), dtype=np.uint8)
    n_ref = len(r)
    n_seq = len(q)
    if n_ref == 0 or n_seq == 0:
        return 0
    iota = np.arange(n_ref + 1, dtype=np.int32)
    decay = gap * iota
    prev = np.zeros(n_ref + 1, dtype=np.int32)
    best = 0
    for j in range(1, n_seq + 1):
        sub = np.where(r == q[j - 1], match, mismatch).astype(np.int32)
        vert = np.empty(n_ref + 1, dtype=np.int32)
        vert[0] = gap * j
        vert[1:] = np.maximum(prev[:-1] + sub, prev[1:] + gap)
        col = np.maximum.accumulate(vert - decay) + decay
        # interior cells only (i >= 1)
        m = int(col[1:].max(initial=-(1 << 30)))
        if m > best:
            best = m
        prev = col
    return best


def _cxx_double(x: float) -> str:
    return f"{x:.6g}"


def localalign_stream(lines, match: int, mismatch: int, gap: int,
                      threshold: float):
    """``localalign`` main loop (``localalign.cpp:52-90``): TSV rows
    (id, reference, sequence) in; (id, score, percent) out for rows at or
    above threshold."""
    for line in lines:
        line = line.rstrip("\n")
        fields = line.split("\t")
        if len(fields) < 3:
            raise ValueError(f"format error: {line!r}")
        id_, reference, sequence = fields[0], fields[1], fields[2]
        score = simple_align_score(reference, sequence, match, mismatch,
                                   gap)
        max_score = len(sequence) * match
        percent = score / max_score
        if percent < threshold:
            continue
        yield f"{id_}\t{score}\t{_cxx_double(percent)}"
