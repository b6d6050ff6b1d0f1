"""Split-read dynamic program — breakpoint discovery kernel.

Replaces ``tools/SplitReadAligner.cpp``: two global-ish DP matrices — read
vs ref1 (forward) and reversed read vs reversed ref2 — and a split at read
offset k scoring ``rowmax(M1, k) + rowmax(M2, L-k)`` with a per-side
minimum anchor score, maximized over k (``SplitReadAligner.cpp:156-227``).

All scores are integers, so every formulation here is exact (no fp order
concerns).  The recurrence (no clamping at zero; end-gaps in the read cost
``gap``, leading ref positions are free):

    M[0][j] = j * gap                      (read consumed, no ref)
    M[i][0] = 0                            (ref consumed, no read)
    M[i][j] = max(M[i-1][j-1] + sub(i,j), M[i-1][j] + gap, M[i][j-1] + gap)

The in-row horizontal dependency (``M[i-1][j] + gap``) is a prefix-max
with linear decay, so each row is computable with vectorized ops plus one
cumulative max — the same structure the TPU Pallas kernel uses (ref
positions on lanes, row loop sequential).  ``ops/split_dp_tpu.py`` holds
the batched device kernel; this module is the exact oracle and the host
fallback.
"""

from __future__ import annotations

import dataclasses

import numpy as np

MATCH = 2
MISMATCH = -1
GAP = -2
MIN_ANCHOR = 4
MIN_SPLIT_SCORE = MIN_ANCHOR * MATCH

def encode_seq(seq: str) -> np.ndarray:
    """Raw bytes; only exact character equality matches, like the
    reference's ``seq1[i] == seq2[j]`` comparison (case-sensitive,
    N never matches N is NOT true — N==N matches, as in the reference)."""
    return np.frombuffer(seq.encode(), dtype=np.uint8)


def fill_matrix(ref: str, read: str) -> np.ndarray:
    """DP matrix (len(ref)+1, len(read)+1), exact reference semantics
    (``SplitReadAligner.cpp:24-75``), row-vectorized."""
    r = encode_seq(ref)
    q = encode_seq(read)
    n_ref = len(r)
    n_read = len(q)
    m = np.zeros((n_ref + 1, n_read + 1), dtype=np.int32)
    # column j: read consumed j bases with no ref -> j*gap at i==0
    m[0, 1:] = GAP * np.arange(1, n_read + 1, dtype=np.int32)

    iota = np.arange(n_ref + 1, dtype=np.int32)
    decay = GAP * iota
    prev = m[:, 0].copy()  # column j-1 over all i
    prev[0] = 0
    col = np.empty(n_ref + 1, dtype=np.int32)
    for j in range(1, n_read + 1):
        sub = np.where(r == q[j - 1], MATCH, MISMATCH).astype(np.int32)
        # candidates from the previous column (vertical + diagonal)
        vert = np.empty(n_ref + 1, dtype=np.int32)
        vert[0] = m[0, j]
        cand = np.maximum(prev[:-1] + sub, prev[1:] + GAP)
        vert[1:] = cand
        # horizontal: col[i] = max over k<=i of vert[k] + (i-k)*gap
        col = np.maximum.accumulate(vert - decay) + decay
        m[:, j] = col
        prev = col
    return m


@dataclasses.dataclass
class SplitHit:
    ref_split: tuple[int, int]
    read_split: tuple[int, int]
    score: int
    score1: int
    score2: int


def _row_max(matrix: np.ndarray, j: int, min_accepted: int) -> int:
    row = matrix[:, j]
    mx = int(row.max(initial=0))
    return mx if mx >= min_accepted else 0


def _row_max_columns(matrix: np.ndarray, j: int, min_accepted: int):
    row = matrix[:, j]
    mx = int(row.max(initial=0))
    if mx < min_accepted:
        return 0, []
    return mx, np.nonzero(row == mx)[0].tolist()


class SplitReadAligner:
    """Exact split alignment of one read against a reference pair."""

    def __init__(self, ref1: str, ref2: str):
        self.ref1 = ref1
        self.ref2 = ref2
        self.ref2_rev = ref2[::-1]

    def align(self, read: str, min_score: int, force_split: bool = True):
        """All maximal split alignments (``SplitReadAligner::GetAlignments``
        with firstOnly=false).  Returns a list of SplitHit in the
        reference's enumeration order (k ascending, then ref1 column, then
        ref2 column)."""
        m1 = fill_matrix(self.ref1, read)
        m2 = fill_matrix(self.ref2_rev, read[::-1])

        if not force_split:
            best = max(int(m1.max(initial=0)), int(m2.max(initial=0)))
            if best >= min_score:
                return []

        n_read = len(read)
        # row maxima with anchor threshold
        rm1 = np.array([_row_max(m1, j, MIN_SPLIT_SCORE)
                        for j in range(n_read + 1)])
        rm2 = np.array([_row_max(m2, j, MIN_SPLIT_SCORE)
                        for j in range(n_read + 1)])
        totals = rm1 + rm2[::-1]

        max_score = 0
        ks = []
        for k in range(n_read + 1):
            t = int(totals[k])
            if t >= min_score and t > max_score:
                max_score = t
                ks = [k]
            elif t >= min_score and t == max_score:
                ks.append(k)

        if max_score == 0:
            return []

        hits = []
        for k in ks:
            s1, cols1 = _row_max_columns(m1, k, MIN_SPLIT_SCORE)
            s2, cols2 = _row_max_columns(m2, n_read - k, MIN_SPLIT_SCORE)
            for i1 in cols1:
                for i2 in cols2:
                    hits.append(SplitHit(
                        ref_split=(i1, len(self.ref2) - i2 - 1),
                        read_split=(k, n_read - k),
                        score=max_score, score1=s1, score2=s2))
        self._last = (m1, m2, read)
        return hits

    def matches_for_hit(self, hit: SplitHit):
        """Backtraced per-base matches for a hit from the last align()
        call; matches2 are remapped to forward ref2/read coordinates
        (``SplitReadAligner::ReverseMatches``)."""
        m1, m2, read = self._last
        n_read = len(read)
        k = hit.read_split[0]
        i1 = hit.ref_split[0]
        i2 = len(self.ref2) - hit.ref_split[1] - 1
        matches1 = backtrace_matches(m1, self.ref1, read, i1, k)
        matches2 = backtrace_matches(m2, self.ref2_rev, read[::-1], i2,
                                     n_read - k)
        matches2 = [(len(self.ref2) - a - 1, n_read - b - 1)
                    for a, b in matches2]
        matches2.reverse()
        return matches1, matches2


def backtrace_matches(matrix: np.ndarray, ref: str, read: str,
                      start_i: int, start_j: int):
    """Match positions along the stored backtrace path from (start_i,
    start_j) (``SplitReadAligner::BackTracePath``).  The stored pointer is
    the last equal-scoring branch in fill order: gapRead > gapRef > match
    (``SplitReadAligner.cpp:56-69``)."""
    r = encode_seq(ref)
    q = encode_seq(read)
    matches = []
    i, j = start_i, start_j
    while j > 0:
        if i == 0:
            nj = j - 1
            ni = i
        else:
            val = matrix[i, j]
            if matrix[i, j - 1] + GAP == val:
                ni, nj = i, j - 1
            elif matrix[i - 1, j] + GAP == val:
                ni, nj = i - 1, j
            else:
                ni, nj = i - 1, j - 1
        if ni == i - 1 and nj == j - 1:
            matches.append((i - 1, j - 1))
        i, j = ni, nj
    matches.reverse()
    return matches


def render_alignment_text(fragment: int, read_end: int, read_seq: str,
                          ref1_len: int, matches1, matches2) -> str:
    """Per-candidate alignment text (``SplitAlignment.cpp:402-437``)."""
    parts = [f"{fragment}{'/1' if read_end == 0 else '/2'}\n"]
    prev = -1
    for refpos, readpos in matches1:
        gap = refpos - prev - 1
        parts.append((" " if prev == -1 else "-") * gap)
        parts.append(read_seq[readpos])
        prev = refpos
    parts.append("-" * (ref1_len - prev - 1 + 1))
    prev = -1
    for refpos, readpos in matches2:
        parts.append("-" * (refpos - prev - 1))
        parts.append(read_seq[readpos])
        prev = refpos
    parts.append("\n")
    return "".join(parts)


def accept_threshold(read_length: int) -> int:
    """Score acceptance bound: 90% of perfect
    (``SplitAlignment.cpp:379``: float widths promote to double before the
    0.90 multiply, then truncate)."""
    return int(float(read_length) * float(MATCH) * 0.90)
