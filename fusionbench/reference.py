"""The plain reference: what deFuse's semantics give on a generated library.

It reads only the library's truth (``generator.Library``), the genes and
the configuration's guarantees, and imports nothing of the program.  On a
random genome a read can align only where it came from (a chance hit of a
random read with at most two mismatches elsewhere in tens of Mb has odds
under 1e-20), so each read end is aligned where its bases lie:

* a read inside one cDNA aligns there with no mismatch;
* a read across a fusion junction aligns, ungapped, to the 5' gene's
  continuation when its 3' part differs from it in at most
  ``align_mismatches`` bases, and to the 3' gene's preceding bases likewise;
* a decoy's random mate aligns nowhere.

The frontend's split of the pairs follows deFuse's ``alignjob``: a pair
whose two full-length reads align to one transcript is concordant (every
insert here is under ``max_insert_size``); of the rest, reads are trimmed
to ``discord_read_trim`` and aligned again, a pair whose two ends share a
gene is dropped (``find_concordant_gene``), one with both ends aligned is
spanning and one with one end improper.

The fusions' expected calls: each planted fusion at its breakpoint, which
may slide along bases that the two genes share at the junction
(``breakpoint_homology``), in each gene's cDNA coordinates; its spanning
count is its fragments the split above calls spanning.
"""

from __future__ import annotations

import dataclasses

import numpy as np

from generator import (COMP, KIND_BACKGROUND, KIND_DECOY, KIND_FUSION,
                       Genes, Library)

# the frontend's split of the pairs; GENOME_PAIR: concordant at a genomic
# locus only (no row in the cDNA pair table that read stats count)
CONCORDANT, SPANNING, IMPROPER, UNALIGNED, SAME_GENE, GENOME_PAIR = range(6)


@dataclasses.dataclass
class Expected:
    """What a correct run gives: the frontend's class of each pair, and for
    each planted fusion its genes, its allowed breakpoints and its spanning
    count."""
    classes: np.ndarray                 # (N,) int8
    gene_ids: list[tuple[int, int]]     # (5' gene, 3' gene) a fusion
    breakpoints: list[set]              # {(5' cDNA pos, 3' cDNA pos)}
    span_counts: np.ndarray             # (F,) int


def transcript_to_genome(genes: Genes, g, pos) -> np.ndarray:
    """1-based cDNA positions of gene(s) ``g`` to genomic positions
    (``g`` one gene or an array beside ``pos``)."""
    g = np.broadcast_to(np.asarray(g), np.shape(pos))
    pos = np.asarray(pos)
    ex = genes.exons[g]                                # (..., E, 2)
    lens = ex[..., 1] - ex[..., 0] + 1
    ends = np.cumsum(lens, axis=-1)
    fwd = np.where(genes.strand[g] == 1, ends[..., -1] - pos + 1, pos)
    k = np.minimum((fwd[..., None] > ends).sum(axis=-1), lens.shape[-1] - 1)

    def take(a):
        return np.take_along_axis(a, k[..., None], axis=-1)[..., 0]
    return take(ex[..., 0]) + fwd - (take(ends) - take(lens)) - 1


def _genome_bases(genes: Genes, g, gpos) -> np.ndarray:
    """The bases of gene ``g``'s chromosome at genomic positions ``gpos``,
    read in the gene's transcript orientation (complemented on strand -)."""
    chrom = genes.chrom[g]
    lo = genes.chrom_offsets[chrom - 1]
    hi = genes.chrom_offsets[chrom] - 1
    idx = np.clip(lo[..., None] + gpos - 1, lo[..., None], hi[..., None])
    base = genes.genome[idx]
    return np.where((genes.strand[g] == 1)[..., None], COMP[base], base)


def _places(lib: Library, genes: Genes, lo: np.ndarray, hi: np.ndarray,
            mm: int) -> list[dict]:
    """The places where the fusion-coordinate intervals [lo, hi] (one a
    fusion pair, as many as ``lib.kind == KIND_FUSION``) align, ungapped
    with at most ``mm`` mismatches.  A read lies at most across the
    junction and one exon boundary on each side (exons are longer than
    reads), so its places are: the 5' gene's cDNA, the 3' gene's cDNA, and
    the genome as placed by the read's first or last base in each gene
    (which puts that base's exon where it is and the rest of the read
    against the chromosome beside it).  Each place: ``gene`` (ids), ``ok``
    (bool), and for genomic ones ``sign`` (+1 or -1, the gene's strand),
    ``start`` and ``end`` (the read's genomic span)."""
    fm = lib.kind == KIND_FUSION
    f = lib.fusion[fm]
    fus = lib.fusions
    ga, gb = fus.a[f], fus.b[f]
    ba, bb = fus.break_a[f], fus.break_b[f]
    width = int((hi - lo).max(initial=0)) + 1
    p = lo[:, None] + np.arange(width)[None, :]
    inside = p <= hi[:, None]
    in_b = p > ba[:, None]
    to_b = bb - ba - 1                      # fusion position -> 3' cDNA
    last = len(genes.cdna) - 1
    a_cdna = genes.cdna[np.clip(genes.offsets[ga][:, None] + p - 1, 0, last)]
    b_cdna = genes.cdna[np.clip(genes.offsets[gb][:, None] + p +
                                to_b[:, None] - 1, 0, last)]
    read = np.where(in_b, b_cdna, a_cdna)

    def fits(locus):
        return ((read != locus) & inside).sum(axis=1) <= mm

    has_a, has_b = lo <= ba, hi > ba
    places = [{"gene": ga, "ok": has_a & fits(a_cdna)},
              {"gene": gb, "ok": has_b & fits(b_cdna)}]
    top_a, low_b = np.minimum(hi, ba), np.maximum(lo, ba + 1)
    for gene, valid, anchors, shift in (
            (ga, has_a, (lo, top_a), 0), (gb, has_b, (low_b, hi), to_b)):
        sign = np.where(genes.strand[gene] == 1, -1, 1)
        for p0 in anchors:
            g0 = transcript_to_genome(genes, gene, p0 + shift)
            at = g0[:, None] + sign[:, None] * (p - p0[:, None])
            ends = g0 + sign * (np.stack([lo, hi]) - p0)
            places.append({
                "gene": gene, "sign": sign,
                "ok": valid & fits(_genome_bases(genes, gene, at)),
                "start": ends.min(axis=0), "end": ends.max(axis=0)})
    return places


def _fusion_frags(lib: Library, genes: Genes, n_bases: int, mm: int):
    """``_places`` of both ends' first ``n_bases`` bases."""
    fm = lib.kind == KIND_FUSION
    s, e = lib.start[fm], lib.start[fm] + lib.flen[fm] - 1
    n = min(n_bases, lib.read_len)
    return [_places(lib, genes, lo, hi, mm)
            for lo, hi in ((s, s + n - 1), (e - n + 1, e))]


def _proper(one: dict, two: dict, max_insert: int) -> np.ndarray:
    """Whether genomic places of end 1 and end 2 make a proper pair
    (``_best_proper_pairs``: one reference, forward before reverse, the
    insert within ``max_insert``); read 1 is forward on a + strand gene."""
    plus = one["sign"] == 1
    fwd_s = np.where(plus, one["start"], two["start"])
    rev_s = np.where(plus, two["start"], one["start"])
    rev_e = np.where(plus, two["end"], one["end"])
    return one["ok"] & two["ok"] & (one["gene"] == two["gene"]) & \
        (fwd_s <= rev_s) & (rev_e - fwd_s + 1 <= max_insert)


def classify(lib: Library, genes: Genes, cfg: dict,
             mm: int | None = None) -> np.ndarray:
    """The frontend's class of each pair (``CONCORDANT`` ... ``GENOME_PAIR``);
    ``mm`` overrides the configuration's mismatch guarantee."""
    if mm is None:
        mm = cfg["guarantees"]["align_mismatches"]
    run_cfg = cfg["defuse"]
    max_insert = int(run_cfg["max_insert_size"])
    N = lib.n_pairs
    fm = lib.kind == KIND_FUSION
    dm = lib.kind == KIND_DECOY

    # concordant: both full-length reads on one transcript, or a proper
    # pair at one genomic locus
    one, two = _fusion_frags(lib, genes, lib.read_len, mm)
    cdna_pair = lib.kind == KIND_BACKGROUND
    cdna_pair[fm] = (one[0]["ok"] & two[0]["ok"]) | \
        (one[1]["ok"] & two[1]["ok"])
    cdna_pair &= lib.flen <= max_insert
    genome_pair = np.zeros(N, bool)
    for x in one[2:]:
        for y in two[2:]:
            genome_pair[fm] |= _proper(x, y, max_insert)

    # the rest, trimmed: which genes each end aligns to
    trim = _fusion_frags(lib, genes, int(run_cfg["discord_read_trim"]), mm)
    fus = lib.fusions
    f = lib.fusion[fm]
    to = [[np.any([pl["ok"] & (pl["gene"] == g) for pl in end], axis=0)
           for g in (fus.a[f], fus.b[f])] for end in trim]
    has = [np.zeros(N, bool), np.zeros(N, bool)]
    same = np.zeros(N, bool)
    for end in (0, 1):
        has[end][fm] = to[end][0] | to[end][1]
    has[0][dm] = True
    same[fm] = (to[0][0] & to[1][0]) | (to[0][1] & to[1][1])
    classes = np.full(N, UNALIGNED, np.int8)
    classes[has[0] ^ has[1]] = IMPROPER
    classes[has[0] & has[1]] = SPANNING
    classes[same] = SAME_GENE
    classes[genome_pair] = GENOME_PAIR
    classes[cdna_pair] = CONCORDANT
    return classes


def genome_to_transcript(genes: Genes, g: int, x: int) -> list[int]:
    """A genomic position near gene ``g`` as 1-based cDNA positions of
    ``g``, one on each exon's line (a breakpoint reported in genomic
    coordinates can lie past its exon, in the intron; its line is the one
    whose exon its alignment held, which the position alone does not
    tell).  A position inside an exon is that exon's cDNA position
    first."""
    ex = genes.exons[g]
    lens = ex[:, 1] - ex[:, 0] + 1
    before = np.concatenate([[0], np.cumsum(lens)[:-1]])
    fwd = before + x - ex[:, 0] + 1
    out = (lens.sum() - fwd + 1) if genes.strand[g] else fwd
    inside = (ex[:, 0] <= x) & (x <= ex[:, 1])
    return [int(t) for t in np.concatenate([out[inside], out[~inside]])]


def _readings(genes: Genes, g: int, t: int, behind: bool, reach: int):
    """The ways to read gene ``g`` around its cDNA position ``t``, each a
    function of a cDNA position giving a base (-1 off the end): its cDNA;
    its chromosome on the line of the exon that holds ``t``; and on the line
    of the exon before it (``behind``) or after it, where that lies within
    ``reach`` bases of ``t``.  On a line the chromosome runs on past the
    exon into the intron, as a genomic alignment does.  Also the cDNA span
    of the exon that holds ``t``."""
    seq = genes.seq(g)
    ex = genes.exons[g]
    lens = ex[:, 1] - ex[:, 0] + 1
    order = np.arange(len(ex))[::-1] if genes.strand[g] else \
        np.arange(len(ex))
    sign = -1 if genes.strand[g] else 1
    first = np.concatenate([[1], 1 + np.cumsum(lens[order])[:-1]])
    k = int(np.searchsorted(first, t, side="right") - 1)

    def cdna(p):
        return int(seq[p - 1]) if 1 <= p <= len(seq) else -1

    def line(j):
        e = order[j]
        at = ex[e, 0] if sign == 1 else ex[e, 1]
        return lambda p: int(_genome_bases(
            genes, np.array([g]), np.array([[at + sign * (p - first[j])]]))[
                0, 0])

    out = [cdna, line(k)]
    span = (int(first[k]), int(first[k] + lens[order[k]] - 1))
    near = k - 1 if behind else k + 1
    if 0 <= near < len(ex) and (t - span[0] < reach if behind else
                                span[1] - t < reach):
        out.append(line(near))
    return out, span


def breakpoints(genes: Genes, lib: Library, f: int) -> set:
    """Fusion ``f``'s breakpoint as (cDNA position of the 5' gene's last
    base, of the 3' gene's first base), wherever a split alignment can put
    it.  The 5' side's alignment can run on over the 3' side's first
    ``right`` bases where they equal what the 5' gene reads next, and the
    3' side's back over the 5' side's last ``left`` bases likewise
    (``breakpoint_homology``); the two ends may then overlap, never leave a
    gap.  A side reads on in its cDNA or in its chromosome (a cluster end
    in genomic coordinates runs into the intron), on the line of the exon
    at the breakpoint or of the exon next to it within a read's length
    (then the bases between must match the intron too).  Where the program
    takes a mismatch into a side's alignment at an exon's edge, its
    breakpoint can lie beyond these (``PERF.md``)."""
    fus = lib.fusions
    ga, gb = int(fus.a[f]), int(fus.b[f])
    ba, bb = int(fus.break_a[f]), int(fus.break_b[f])
    a, b = genes.seq(ga), genes.seq(gb)
    reach = lib.read_len

    def fused(p):        # the fusion's base at p, in the 5' gene's numbering
        return int(a[p - 1]) if p <= ba else \
            (int(b[p - ba + bb - 2]) if p - ba + bb - 1 <= len(b) else -2)

    # a reading counts where it reads the side's bases in the exon at the
    # breakpoint as they are (on the next exon's line, through the intron)
    right = 0
    readings, (first, _) = _readings(genes, ga, ba, True, reach)
    for read_a in readings:
        if all(read_a(p) == fused(p) for p in range(first, ba + 1)):
            k = 0
            while read_a(ba + k + 1) == fused(ba + k + 1):
                k += 1
            right = max(right, k)
    def at(q):           # the fusion's base at the 3' gene's position q
        return fused(q - bb + ba + 1)

    left = 0
    readings, (_, last) = _readings(genes, gb, bb, False, reach)
    for read_b in readings:
        if all(read_b(q) == at(q) for q in range(bb, last + 1)):
            k = 0
            while bb - k - 1 >= 1 and read_b(bb - k - 1) == at(bb - k - 1):
                k += 1
            left = max(left, k)
    return {(ba + x, bb + y) for x in range(-left, right + 1)
            for y in range(-left, x + 1)}


def expected(lib: Library, genes: Genes, cfg: dict,
             mm: int | None = None) -> Expected:
    classes = classify(lib, genes, cfg, mm)
    fus = lib.fusions
    n_f = len(fus.a)
    fm = (lib.kind == KIND_FUSION) & (classes == SPANNING)
    span = np.bincount(lib.fusion[fm], minlength=n_f)
    pairs = [(int(x), int(y)) for x, y in zip(fus.a, fus.b)]
    breaks = [breakpoints(genes, lib, f) for f in range(n_f)]
    return Expected(classes, pairs, breaks, span)
