"""EST-island filter — the ``estislands`` equivalent.

Merges UCSC intronEst PSL alignments into per-chromosome islands and
keeps breakpoint-vs-genome PSL rows fully contained in an island padded
by 300bp (``tools/EstCatalog.cpp``).  Field indices differ between the
two inputs (the EST table carries a leading UCSC ``bin`` column):
ests use tName=14/tStart=16/tEnd=17, breaks use 13/15/16.
"""

from __future__ import annotations

import bisect

PAD = 300


def _norm_chrom(c: str) -> str:
    if c.startswith("chr"):
        c = c[3:]
    if c == "M":
        c = "MT"
    return c


def _psl_rows(lines):
    for line in lines:
        line = line.rstrip("\n")
        if not line or line[0] == "#" or not line[0].isdigit():
            continue
        fields = line.split("\t")
        if len(fields) < 18:
            continue
        yield line, fields


class EstCatalog:
    def __init__(self) -> None:
        self._islands: dict[str, list[tuple[int, int]]] = {}

    def read_ests(self, lines) -> None:
        segs: dict[str, list[tuple[int, int]]] = {}
        for _line, f in _psl_rows(lines):
            chrom = _norm_chrom(f[14])
            segs.setdefault(chrom, []).append((int(f[16]) + 1, int(f[17])))
        for chrom, s in segs.items():
            s.sort()
            merged = []
            cur_s, cur_e = s[0]
            for st, en in s:
                if st > cur_e:
                    merged.append((cur_s, cur_e))
                    cur_s, cur_e = st, en
                else:
                    cur_e = max(cur_e, en)
            merged.append((cur_s, cur_e))
            self._islands[chrom] = merged

    def contained(self, chrom: str, start: int, end: int) -> bool:
        islands = self._islands.get(chrom, [])
        idx = bisect.bisect_left(islands, (start, -(1 << 60)))
        if idx > 0:
            idx -= 1
        while idx < len(islands) and islands[idx][0] <= end:
            s, e = islands[idx]
            if s - PAD <= start and e + PAD >= end:
                return True
            idx += 1
        return False

    def filter_contained(self, lines):
        """Yield break PSL lines fully contained in a padded island."""
        for line, f in _psl_rows(lines):
            chrom = _norm_chrom(f[13])
            start, end = int(f[15]) + 1, int(f[16])
            if self.contained(chrom, start, end):
                yield line
