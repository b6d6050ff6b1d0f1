"""Fragment-length/read-length statistics and per-gene expression counts.

Equivalents of ``scripts/read_stats.pl``, ``scripts/merge_read_stats.pl``
(associative sums/sum-of-squares merge — the psum contract for the
distributed path) and ``scripts/calculate_expression_simple.pl`` /
``scripts/merge_expression.pl``.
"""

from __future__ import annotations

import dataclasses
import math


@dataclasses.dataclass
class ReadStats:
    frag_count: int
    fraglength_mean: float
    fraglength_stddev: float
    readlength_min: int
    readlength_max: int
    readlengths: tuple[int, ...] = ()

    def format(self) -> str:
        head = ("frag_count\tfraglength_mean\tfraglength_stddev\t"
                "readlength_min\treadlength_max\treadlengths_list")
        lst = ",".join(str(x) for x in self.readlengths)
        row = (f"{self.frag_count}\t{_perl_num(self.fraglength_mean)}\t"
               f"{_perl_num(self.fraglength_stddev)}\t"
               f"{self.readlength_min}\t{self.readlength_max}\t{lst}")
        return head + "\n" + row + "\n"


def _perl_num(x: float) -> str:
    """Perl stringifies doubles with %.15g."""
    if x == int(x) and abs(x) < 1e15:
        return str(int(x))
    return f"{x:.15g}"


def read_stats_from_sam(lines) -> ReadStats:
    """Proper-pair fragment stats from a paired SAM stream
    (``read_stats.pl``): rows come in mate pairs; keep flag-0x2 pairs on
    one reference; fragment length = |isize|."""
    s = 0.0
    ss = 0.0
    n = 0
    readlengths = set()
    it = iter(lines)
    for line1 in it:
        if line1.startswith("@"):
            continue
        line2 = next(it)
        f1 = line1.rstrip("\n").split("\t")
        f2 = line2.rstrip("\n").split("\t")
        if f1[0].rsplit("/", 1)[0] != f2[0].rsplit("/", 1)[0]:
            raise ValueError("SAM mate pairing error")
        if not (int(f1[1]) & 0x2) or not (int(f2[1]) & 0x2):
            continue
        if f1[2] != f2[2]:
            continue
        isize = abs(int(f1[8]))
        s += isize
        ss += isize ** 2
        n += 1
        readlengths.add(len(f1[9]))
        readlengths.add(len(f2[9]))
    if n > 0:
        mean = s / n
        var = ss / n - mean ** 2
        std = var ** 0.5
    else:
        mean = std = 0.0
    rl = sorted(readlengths)
    return ReadStats(n, mean, std, rl[0] if rl else 0, rl[-1] if rl else 0,
                     tuple(rl))


def stats_from_sums(n, s, ss, readlengths) -> ReadStats:
    """Final-formula step shared by the native whole-table scan and the
    exact distributed merge (sum of per-rank integer sums): using ONE
    formula in both places makes merged-from-parts stats bit-identical
    to a single scan — the fragment-length sums are exact integers in
    doubles, so only the final divisions could ever differ."""
    n = int(n)
    rl = sorted(readlengths)
    if n > 0:
        mean = s / n
        var = ss / n - mean ** 2
        return ReadStats(n, mean, var ** 0.5, rl[0] if rl else 0,
                         rl[-1] if rl else 0, tuple(rl))
    return ReadStats(0, 0.0, 0.0, rl[0] if rl else 0,
                     rl[-1] if rl else 0, tuple(rl))


def merge_read_stats(stats: list[ReadStats]) -> ReadStats:
    """Associative merge (``merge_read_stats.pl``): recover sums and
    sums-of-squares, add, re-derive."""
    n = 0
    s = 0.0
    ss = 0.0
    lengths: set[int] = set()
    for st in stats:
        if st.frag_count <= 0:
            continue
        n += st.frag_count
        s += st.fraglength_mean * st.frag_count
        ss += (st.fraglength_stddev ** 2 + st.fraglength_mean ** 2) \
            * st.frag_count
        lengths.update(st.readlengths
                       or (st.readlength_min, st.readlength_max))
    mean = s / n
    var = ss / n - mean ** 2
    rl = sorted(lengths)
    return ReadStats(n, mean, var ** 0.5, rl[0], rl[-1], tuple(rl))


def merge_expression(count_maps) -> dict[str, float]:
    out: dict[str, float] = {}
    for m in count_maps:
        for gene, c in m.items():
            out[gene] = out.get(gene, 0.0) + c
    return out
