"""Breakpoint-sequence alignment — the gmap/blat replacement.

Aligns predicted fusion sequences against reference target sets
(genome per-chromosome spliced / genome unspliced / cdna / ESTs / exons /
cds — ``defuse_run.pl:672-796``) and emits PSL rows feeding the
annotation features (percent identity, homology, ORF phase, exon
boundaries, EST islands).

TPU-first design: exact k-mer seed hits from the shared ``SeedIndex``,
grouped per (target, strand, diagonal) into ungapped blocks, then chained
across diagonals within an intron-size bound (spliced mode) or a small
indel bound (unspliced).  Block match counts come from direct base
comparison.  This reproduces the downstream-visible behavior the
pipeline consumes (max percident per target set, block/boundary
structure); it is not a base-level gmap/blat clone.
"""

from __future__ import annotations

import dataclasses

import numpy as np

from ..core.types import revcomp
from .seedindex import SeedIndex, encode

SEED_STEP = 8


@dataclasses.dataclass
class PslRow:
    matches: int
    t_base_insert: int
    strand: str
    q_name: str
    q_size: int
    q_start: int
    q_end: int
    t_name: str
    t_size: int
    t_start: int
    t_end: int
    blocks: list  # (size, q_start0, t_start0)

    def format(self) -> str:
        f = ["0"] * 21
        f[0] = str(self.matches)
        f[7] = str(self.t_base_insert)
        f[8] = self.strand
        f[9] = self.q_name
        f[10] = str(self.q_size)
        f[11] = str(self.q_start)
        f[12] = str(self.q_end)
        f[13] = self.t_name
        f[14] = str(self.t_size)
        f[15] = str(self.t_start)
        f[16] = str(self.t_end)
        f[17] = str(len(self.blocks))
        f[18] = ",".join(str(b[0]) for b in self.blocks) + ","
        f[19] = ",".join(str(b[1]) for b in self.blocks) + ","
        f[20] = ",".join(str(b[2]) for b in self.blocks) + ","
        return "\t".join(f)


def _seed_hits(index: SeedIndex, codes: np.ndarray):
    """(q_off, global_t_pos) seed hit pairs for one query."""
    k = index.seed_len
    L = len(codes)
    if L < k:
        return np.zeros(0, np.int64), np.zeros(0, np.int64)
    offs = list(range(0, L - k + 1, SEED_STEP))
    keys = np.zeros(len(offs), dtype=np.uint64)
    valid = np.ones(len(offs), dtype=bool)
    for j in range(k):
        win = codes[np.asarray(offs) + j]
        keys = (keys << np.uint64(2)) | win.astype(np.uint64)
        valid &= win < 4
    lo = np.searchsorted(index.keys, keys)
    hi = np.searchsorted(index.keys, keys, side="right")
    counts = np.where(valid, np.minimum(hi - lo, 64), 0)
    total = int(counts.sum())
    q_off = np.repeat(np.asarray(offs), counts)
    flat = np.repeat(lo, counts) + (
        np.arange(total) - np.repeat(np.cumsum(counts) - counts, counts))
    return q_off, index.positions[flat]


XDROP = 12  # +1 match / -3 mismatch: tolerates isolated mismatches,
#             terminates within ~4 consecutive errors — the ungapped
#             x-drop blat/gmap-style extension that keeps percident
#             tracking the real identity of diverged paralogs (a pure
#             exact-run extension under-reported 85-95%-identity
#             paralogs by ~2x; see BREAKSEQ_SENSITIVITY_r4.md)


def _extend_block(codes, tcodes, q, t, k):
    """Maximal ungapped x-drop run around a seed: extend left/right
    through mismatches while the running score (+1 match, -3 mismatch)
    stays within XDROP of its best; the returned span ends at the
    best-scoring positions.  PSL ``matches`` still counts only equal
    bases over the span, so mismatches inside the block lower percident
    exactly as blat's would."""
    L, T = len(codes), len(tcodes)
    best_s = s = 0
    score = best = 0
    while q - s - 1 >= 0 and t - s - 1 >= 0:
        score += 1 if codes[q - s - 1] == tcodes[t - s - 1] else -3
        s += 1
        if score > best:
            best, best_s = score, s
        elif score <= best - XDROP:
            break
    best_e = e = k
    score = best = 0
    while q + e < L and t + e < T:
        score += 1 if codes[q + e] == tcodes[t + e] else -3
        e += 1
        if score > best:
            best, best_e = score, e
        elif score <= best - XDROP:
            break
    return q - best_s, t - best_s, best_s + best_e


def align_breakseq(index: SeedIndex, name: str, seq: str, *,
                   max_gap: int, spliced: bool):
    """PSL rows for one query against the index.

    max_gap bounds the target-side gap between chained blocks (intron
    size in spliced mode, small indels otherwise).
    """
    rows: list[PslRow] = []
    q_size = len(seq)
    for strand, s in (("+", seq), ("-", revcomp(seq))):
        codes = encode(s)
        q_off, t_pos = _seed_hits(index, codes)
        if len(q_off) == 0:
            continue
        seq_idx = np.searchsorted(index.offsets, t_pos,
                                  side="right") - 1
        diag = t_pos - q_off
        order = np.lexsort((q_off, diag, seq_idx))
        q_off, t_pos, seq_idx, diag = (q_off[order], t_pos[order],
                                       seq_idx[order], diag[order])

        # group hits into ungapped blocks per (target, diagonal)
        blocks = []  # (seq_idx, q_start, t_start_local, length)
        i = 0
        n = len(q_off)
        k = index.seed_len
        while i < n:
            j = i
            while j + 1 < n and seq_idx[j + 1] == seq_idx[i] \
                    and diag[j + 1] == diag[i] \
                    and q_off[j + 1] <= q_off[j] + k:
                j += 1
            si = int(seq_idx[i])
            toff = int(index.offsets[si])
            tlen = int(index.seq_lens[si])
            tcodes_view = index.codes[toff:toff + tlen]
            qs, ts, length = _extend_block(
                codes, tcodes_view, int(q_off[i]), int(t_pos[i] - toff),
                k)
            # clip to bounds
            length = min(length, q_size - qs, tlen - ts)
            if length >= k:
                blocks.append((si, qs, ts, length))
            i = j + 1

        # chain blocks per target within the gap bound
        by_target: dict[int, list] = {}
        for b in blocks:
            by_target.setdefault(b[0], []).append(b)
        for si, bl in by_target.items():
            bl = sorted(set((qs, ts, ln) for (_si, qs, ts, ln) in bl))
            chains: list[list] = []
            for (qs, ts, ln) in bl:
                placed = False
                for chain in chains:
                    pq, pt, pl = chain[-1]
                    q_gap = qs - (pq + pl)
                    t_gap = ts - (pt + pl)
                    # same-diagonal gaps are pure mismatch runs (no
                    # indel): chain through them like blat's ungapped
                    # extension would — they lower percident via the
                    # match count, not by truncating the alignment
                    if q_gap >= -8 and t_gap >= -8 and \
                            t_gap <= max_gap and \
                            (q_gap <= 30 or
                             (q_gap == t_gap and q_gap <= 200)):
                        chain.append((qs, ts, ln))
                        placed = True
                        break
                if not placed:
                    chains.append([(qs, ts, ln)])
            for chain in chains:
                # trim overlaps between consecutive blocks
                cleaned = [chain[0]]
                for (qs, ts, ln) in chain[1:]:
                    pq, pt, pl = cleaned[-1]
                    trim = max(pq + pl - qs, pt + pl - ts, 0)
                    if ln - trim <= 0:
                        continue
                    cleaned.append((qs + trim, ts + trim, ln - trim))
                matches = 0
                toff = int(index.offsets[si])
                for (qs, ts, ln) in cleaned:
                    matches += int(np.sum(
                        codes[qs:qs + ln] ==
                        index.codes[toff + ts:toff + ts + ln]))
                if matches < index.seed_len:
                    continue
                t_ins = sum(
                    max(0, (cleaned[m + 1][1] - (cleaned[m][1]
                                                 + cleaned[m][2]))
                        - (cleaned[m + 1][0] - (cleaned[m][0]
                                                + cleaned[m][2])))
                    for m in range(len(cleaned) - 1))
                q_start = cleaned[0][0]
                q_end = cleaned[-1][0] + cleaned[-1][2]
                if strand == "-":
                    # PSL reports minus-strand query coords on the plus
                    # strand of the query
                    q_start_psl = q_size - q_end
                    q_end_psl = q_size - q_start
                else:
                    q_start_psl, q_end_psl = q_start, q_end
                rows.append(PslRow(
                    matches=matches, t_base_insert=t_ins, strand=strand,
                    q_name=name, q_size=q_size, q_start=q_start_psl,
                    q_end=q_end_psl, t_name=index.names[si],
                    t_size=int(index.seq_lens[si]),
                    t_start=cleaned[0][1],
                    t_end=cleaned[-1][1] + cleaned[-1][2],
                    blocks=[(ln, qs, ts) for (qs, ts, ln) in cleaned]))
    return rows


def align_breakpoints(seqs: dict[int, str], targets: dict[str, SeedIndex],
                      outdir, *, genome_max_gap: int = 500000,
                      small_gap: int = 30):
    """Align all breakpoint sequences against every target set; write
    breakpoints.<target>.psl files.  ``genome`` gets spliced mode plus a
    ``genome.nointron`` unspliced variant (``defuse_run.pl:732-796``)."""
    import pathlib

    out = pathlib.Path(outdir)
    paths = {}
    for tname, index in targets.items():
        specs = [(tname, genome_max_gap if tname in ("genome", "cdna",
                                                     "est")
                  else small_gap)]
        if tname == "genome":
            specs.append(("genome.nointron", small_gap))
        for label, gap in specs:
            path = out / f"breakpoints.{label}.psl"
            with open(path, "w") as fh:
                for cid in sorted(seqs):
                    seq = seqs[cid].replace("|", "")
                    if not seq or seq == "N":
                        continue
                    for row in align_breakseq(index, str(cid), seq,
                                              max_gap=gap,
                                              spliced=gap > 1000):
                        fh.write(row.format() + "\n")
            paths[label] = str(path)
    return paths
