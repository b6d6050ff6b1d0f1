"""Breakpoint-sequence alignment — the gmap/blat replacement.

Aligns predicted fusion sequences against reference target sets
(genome per-chromosome spliced / genome unspliced / cdna / ESTs / exons /
cds — ``defuse_run.pl:672-796``) and emits PSL rows feeding the
annotation features (percent identity, homology, ORF phase, exon
boundaries, EST islands).

Design: exact k-mer seed hits from the shared ``SeedIndex``, grouped per
(target, strand, diagonal) into ungapped blocks, then chained across
diagonals within an intron-size bound (spliced mode) or a small indel
bound (unspliced).  Block match counts come from direct base comparison.
This reproduces the downstream-visible behavior the pipeline consumes
(max percident per target set, block/boundary structure); it is not a
base-level gmap/blat clone.

A target is aligned in one batched pass over every query and both
strands: the seeds of all of them are keyed and searched at once (inside
the buckets of the index's prefix table where it has one), their hits
grouped into blocks with one sort, and every block's x-drop extension
compared along its diagonal as an array.  Only the chaining runs a
(query, strand, target sequence) at a time.  The genome's blocks are
made once and chained twice, spliced and unspliced.
"""

from __future__ import annotations

import dataclasses

import numpy as np

from ..core.types import revcomp
from .seedindex import SeedIndex, encode

SEED_STEP = 8
MAX_SEED_HITS = 64


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


XDROP = 12  # +1 match / -3 mismatch: tolerates isolated mismatches,
#             terminates within ~4 consecutive errors — the ungapped
#             x-drop blat/gmap-style extension that keeps percident
#             tracking the real identity of diverged paralogs (a pure
#             exact-run extension under-reported 85-95%-identity
#             paralogs by ~2x; see BREAKSEQ_SENSITIVITY_r4.md)


@dataclasses.dataclass
class _Queries:
    """Queries on both strands in one flat code array: row ``2 * i + s``
    is query ``i`` on strand ``"+-"[s]``, ``codes[starts[r]:starts[r +
    1]]``."""
    names: list
    sizes: np.ndarray       # len(seq) of each query
    codes: np.ndarray
    starts: np.ndarray

    @classmethod
    def of(cls, queries: list[tuple[str, str]]) -> "_Queries":
        parts = []
        for _name, seq in queries:
            parts += [encode(seq), encode(revcomp(seq))]
        starts = np.zeros(len(parts) + 1, np.int64)
        starts[1:] = np.cumsum([len(p) for p in parts])
        return cls([name for name, _seq in queries],
                   np.array([len(seq) for _name, seq in queries], np.int64),
                   np.concatenate(parts) if parts else np.zeros(0, np.int8),
                   starts)


def _key_ranges(index: SeedIndex, keys: np.ndarray):
    """``searchsorted(index.keys, keys)``, left and right: a binary search
    inside each key's bucket of the prefix table where the index has one
    (a few keys in tens of millions), else over the whole table."""
    table = np.asarray(index.keys)
    if index.prefix_table is None:
        return (np.searchsorted(table, keys),
                np.searchsorted(table, keys, side="right"))
    bits = 2 * index.seed_len
    bucket = (keys >> np.uint64(bits - min(bits, 22))).astype(np.int64)
    ptab = np.asarray(index.prefix_table)
    lo, hi = ptab[bucket], ptab[bucket + 1]

    def bisect(lo, hi, right):
        lo, hi = lo.copy(), hi.copy()
        live = np.flatnonzero(lo < hi)
        while len(live):
            a, b = lo[live], hi[live]
            mid = (a + b) >> 1
            v, key = table[mid], keys[live]
            up = v <= key if right else v < key
            lo[live] = np.where(up, mid + 1, a)
            hi[live] = np.where(up, b, mid)
            live = live[lo[live] < hi[live]]
        return lo

    first = bisect(lo, hi, False)
    return first, bisect(first, hi, True)


def _seed_hits(index: SeedIndex, qs: _Queries):
    """Every seed hit of every row: (row, q_off, global t_pos) in each
    row's order of seeds, at most MAX_SEED_HITS a seed, and the number of
    seeds searched."""
    k = index.seed_len
    lens = np.diff(qs.starts)
    n_win = np.where(lens >= k, (lens - k) // SEED_STEP + 1, 0)
    row = np.repeat(np.arange(len(lens)), n_win)
    q_off = SEED_STEP * (np.arange(len(row))
                         - np.repeat(np.cumsum(n_win) - n_win, n_win))
    at = qs.starts[row] + q_off
    keys = np.zeros(len(row), np.uint64)
    valid = np.ones(len(row), bool)
    for j in range(k):
        win = qs.codes[at + j]
        keys = (keys << np.uint64(2)) | win.astype(np.uint64)
        valid &= win < 4
    row, q_off, keys = row[valid], q_off[valid], keys[valid]
    lo, hi = _key_ranges(index, keys)
    counts = np.minimum(hi - lo, MAX_SEED_HITS)
    flat = np.repeat(lo - (np.cumsum(counts) - counts), counts) \
        + np.arange(int(counts.sum()))
    return (np.repeat(row, counts), np.repeat(q_off, counts),
            np.asarray(index.positions)[flat], len(keys))


def _xdrop(qcodes, tcodes, qpos, tpos, step, room):
    """Steps to the best point of each block's ungapped x-drop extension:
    step ``j`` compares ``qcodes[qpos + step * j]`` with ``tcodes[tpos +
    step * j]`` (+1 match, -3 mismatch), for ``j`` up to ``room``, and the
    extension stops at the first step whose score is XDROP below the best
    so far; the best is the first step that reaches the highest score (0
    where none rises above 0).  All blocks advance together, a window of
    steps at a time, the window doubling while any block goes on."""
    best_at = np.zeros(len(qpos), np.int64)
    best = np.zeros(len(qpos), np.int64)
    score = np.zeros(len(qpos), np.int64)
    live = np.flatnonzero(room > 0)
    done, width = 0, 16
    while len(live):
        j = done + np.arange(1, width + 1)
        r = room[live, None]
        jj = step * np.minimum(j, r)
        eq = qcodes[qpos[live, None] + jj] == tcodes[tpos[live, None] + jj]
        inside = j <= r
        cum = score[live, None] + np.cumsum(np.where(eq & inside, 1, -3),
                                            axis=1)
        run = np.maximum(np.maximum.accumulate(cum, axis=1),
                         best[live, None])
        stop = (cum <= run - XDROP) & inside
        broke = stop.any(axis=1)
        m = np.arange(len(live))
        last = np.where(broke, stop.argmax(axis=1),
                        np.minimum(room[live] - done, width) - 1)
        top = run[m, last]
        up = top > best[live]
        best_at[live[up]] = done + 1 + (run[up] >= top[up, None]).argmax(
            axis=1)
        best[live] = top
        score[live] = cum[m, last]
        live = live[~broke & (room[live] > done + width)]
        done += width
        width *= 2
    return best_at


@dataclasses.dataclass
class _Blocks:
    """Ungapped blocks, unique and sorted by (row, seq_idx, q_start,
    t_start, length); t_start is local to the target sequence."""
    row: np.ndarray
    seq_idx: np.ndarray
    q_start: np.ndarray
    t_start: np.ndarray
    length: np.ndarray


def _blocks(index: SeedIndex, qs: _Queries, row, q_off, t_pos) -> _Blocks:
    """The hits grouped per (row, target sequence, diagonal) into runs of
    seeds at most a seed apart, each run's first seed extended both ways,
    clipped to the query and the target and kept from seed length up."""
    k = index.seed_len
    seq_idx = np.searchsorted(index.offsets, t_pos, side="right") - 1
    diag = t_pos - q_off
    order = np.lexsort((q_off, diag, seq_idx, row))
    row, q_off, t_pos, seq_idx, diag = (row[order], q_off[order],
                                        t_pos[order], seq_idx[order],
                                        diag[order])
    head = np.ones(len(row), bool)
    head[1:] = (row[1:] != row[:-1]) | (seq_idx[1:] != seq_idx[:-1]) \
        | (diag[1:] != diag[:-1]) | (q_off[1:] > q_off[:-1] + k)
    row, q, si = row[head], q_off[head], seq_idx[head]
    toff = index.offsets[si]
    tlen = index.seq_lens[si]
    t = t_pos[head] - toff
    qbase = qs.starts[row]
    qlen = qs.starts[row + 1] - qbase
    tcodes = np.asarray(index.codes)
    left = _xdrop(qs.codes, tcodes, qbase + q, toff + t, -1,
                  np.minimum(q, t))
    right = _xdrop(qs.codes, tcodes, qbase + q + k - 1, toff + t + k - 1, 1,
                   np.maximum(np.minimum(qlen - q - k, tlen - t - k), 0))
    q0, t0 = q - left, t - left
    length = np.minimum(np.minimum(left + k + right,
                                   qs.sizes[row // 2] - q0), tlen - t0)
    keep = length >= k
    cols = [length[keep], t0[keep], q0[keep], si[keep], row[keep]]
    order = np.lexsort(cols)
    cols = [c[order] for c in cols]
    new = np.ones(len(order), bool)
    new[1:] = np.any([c[1:] != c[:-1] for c in cols], axis=0)
    length, t0, q0, si, row = (c[new] for c in cols)
    return _Blocks(row, si, q0, t0, length)


def _chains(bl: list, max_gap: int) -> list[list]:
    """Blocks (q_start, t_start, length), sorted, chained within the gap
    bound, each chain with its overlaps trimmed."""
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
    out = []
    for chain in chains:
        # trim overlaps between consecutive blocks
        cleaned = [chain[0]]
        for (qs, ts, ln) in chain[1:]:
            pq, pt, pl = cleaned[-1]
            trim = max(pq + pl - qs, pt + pl - ts, 0)
            if ln - trim <= 0:
                continue
            cleaned.append((qs + trim, ts + trim, ln - trim))
        out.append(cleaned)
    return out


def _psl_rows(index: SeedIndex, qs: _Queries, blk: _Blocks,
              max_gap: int) -> list[PslRow]:
    """The PSL rows of the blocks chained within ``max_gap``: by query,
    ``+`` before ``-``, target sequences in index order, chains in the
    order they were opened; a chain of fewer than seed length matches
    makes none."""
    edge = np.flatnonzero((blk.row[1:] != blk.row[:-1])
                          | (blk.seq_idx[1:] != blk.seq_idx[:-1])) + 1
    bounds = [0, *edge.tolist(), len(blk.row)]
    triples = list(zip(blk.q_start.tolist(), blk.t_start.tolist(),
                       blk.length.tolist()))
    rows, sis = blk.row.tolist(), blk.seq_idx.tolist()
    chained = []            # (row, seq_idx, cleaned blocks)
    for a, b in zip(bounds[:-1], bounds[1:]):
        for cleaned in _chains(triples[a:b], max_gap):
            chained.append((rows[a], sis[a], cleaned))
    if not chained:
        return []

    # every chain's matches in one comparison over its blocks' bases
    n_blk = np.array([len(c) for _r, _s, c in chained])
    flat = np.array([b for _r, _s, c in chained for b in c],
                    np.int64).reshape(-1, 3)
    chain_row = np.repeat([r for r, _s, _c in chained], n_blk)
    chain_si = np.repeat([s for _r, s, _c in chained], n_blk)
    ln = flat[:, 2]
    within = np.arange(int(ln.sum())) - np.repeat(np.cumsum(ln) - ln, ln)
    qg = np.repeat(qs.starts[chain_row] + flat[:, 0], ln) + within
    tg = np.repeat(index.offsets[chain_si] + flat[:, 1], ln) + within
    same = (qs.codes[qg] == np.asarray(index.codes)[tg]).astype(np.int64)
    per_block = np.add.reduceat(same, np.cumsum(ln) - ln)
    matches = np.add.reduceat(per_block, np.cumsum(n_blk) - n_blk).tolist()

    out = []
    for (row, si, cleaned), m in zip(chained, matches):
        if m < index.seed_len:
            continue
        q_size = int(qs.sizes[row // 2])
        t_ins = sum(
            max(0, (cleaned[i + 1][1] - (cleaned[i][1] + cleaned[i][2]))
                - (cleaned[i + 1][0] - (cleaned[i][0] + cleaned[i][2])))
            for i in range(len(cleaned) - 1))
        q_start = cleaned[0][0]
        q_end = cleaned[-1][0] + cleaned[-1][2]
        strand = "+-"[row % 2]
        if strand == "-":
            # PSL reports minus-strand query coords on the plus
            # strand of the query
            q_start, q_end = q_size - q_end, q_size - q_start
        out.append(PslRow(
            matches=m, t_base_insert=t_ins, strand=strand,
            q_name=qs.names[row // 2], q_size=q_size, q_start=q_start,
            q_end=q_end, t_name=index.names[si],
            t_size=int(index.seq_lens[si]), t_start=cleaned[0][1],
            t_end=cleaned[-1][1] + cleaned[-1][2],
            blocks=[(ln, q, t) for (q, t, ln) in cleaned]))
    return out


def _align(index: SeedIndex, queries: list[tuple[str, str]],
           max_gaps: list[int], counts: dict | None = None
           ) -> list[list[PslRow]]:
    """PSL rows of every (name, seq) query against the index, a list for
    each chaining gap bound, from one pass of seeding and extension;
    ``counts`` gains what the pass carried."""
    qs = _Queries.of(queries)
    row, q_off, t_pos, n_seeds = _seed_hits(index, qs)
    blk = _blocks(index, qs, row, q_off, t_pos)
    out = [_psl_rows(index, qs, blk, gap) for gap in max_gaps]
    if counts is not None:
        for key, n in (("queries", len(queries)), ("seeds", n_seeds),
                       ("hits", len(row)), ("blocks", len(blk.row)),
                       ("rows", sum(map(len, out)))):
            counts[key] = counts.get(key, 0) + n
    return out


def align_breakseq(index: SeedIndex, name: str, seq: str, *,
                   max_gap: int, spliced: bool):
    """PSL rows for one query against the index.

    max_gap bounds the target-side gap between chained blocks (intron
    size in spliced mode, small indels otherwise).
    """
    return _align(index, [(name, seq)], [max_gap])[0]


def align_breakpoints(seqs: dict[int, str], targets: dict[str, SeedIndex],
                      outdir, *, genome_max_gap: int = 500000,
                      small_gap: int = 30, counts: dict | None = None):
    """Align all breakpoint sequences against every target set; write
    breakpoints.<target>.psl files.  ``genome`` gets spliced mode plus a
    ``genome.nointron`` unspliced variant (``defuse_run.pl:732-796``),
    chained from the same blocks.  ``counts`` gains the queries, seeds,
    hits, blocks and rows of each target's pass."""
    import pathlib

    out = pathlib.Path(outdir)
    queries = []
    for cid in sorted(seqs):
        seq = seqs[cid].replace("|", "")
        if seq and seq != "N":
            queries.append((str(cid), seq))
    paths = {}
    for tname, index in targets.items():
        specs = [(tname, genome_max_gap if tname in ("genome", "cdna",
                                                     "est")
                  else small_gap)]
        if tname == "genome":
            specs.append(("genome.nointron", small_gap))
        rows = _align(index, queries, [gap for _label, gap in specs], counts)
        for (label, _gap), label_rows in zip(specs, rows):
            path = out / f"breakpoints.{label}.psl"
            with open(path, "w") as fh:
                fh.writelines(row.format() + "\n" for row in label_rows)
            paths[label] = str(path)
    return paths
