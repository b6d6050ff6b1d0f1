"""The plain reference against brute force, and the comparison against
its own answer and against the control."""

import numpy as np

import compare
import control as C
import generator as G
import observe
import reference as R
from test_fb_generator import tiny


def windows(seq, n):
    return np.lib.stride_tricks.sliding_window_view(seq, n)


def brute_genes(lib, genes, i, end, n, mm):
    """Genes that the first ``n`` bases of end ``end`` of fusion pair ``i``
    align to, by comparing them with every window of both genes' cDNAs and
    of the chromosome around each gene."""
    f = lib.fusion[i]
    fus = lib.fusions
    seq = fus.seq(genes, f)
    s, e = lib.start[i] - 1, lib.start[i] - 1 + lib.flen[i]
    lo = s if end == 0 else e - n
    piece = seq[lo:lo + n]
    hit = set()
    for g in (int(fus.a[f]), int(fus.b[f])):
        best = (windows(genes.seq(g), n) != piece).sum(axis=1).min()
        c = genes.chrom[g]
        chrom = genes.genome[genes.chrom_offsets[c - 1]:genes.chrom_offsets[c]]
        a, b = genes.exons[g].min() - 1 - n, genes.exons[g].max() + n
        target = G.revcomp(piece) if genes.strand[g] else piece
        best = min(best, (windows(chrom[a:b], n) != target).sum(axis=1).min())
        if best <= mm:
            hit.add(g)
    return hit


def test_alignment_at_the_locus_equals_brute_force():
    cfg, mix, genes = tiny()
    lib = G.make_library(cfg, mix, genes, 5, 2000)
    fm = lib.kind == G.KIND_FUSION
    f = lib.fusion[fm]
    for mm in (0, 2):
        for n in (lib.read_len, 30):
            places = R._fusion_frags(lib, genes, n, mm)
            for k, i in enumerate(np.flatnonzero(fm)):
                for end in (0, 1):
                    have = {int(pl["gene"][k]) for pl in places[end]
                            if pl["ok"][k]}
                    assert have == brute_genes(lib, genes, i, end, n, mm), \
                        (i, end, n, mm, f[k])


def test_transcript_to_genome_walks_the_exons():
    _, _, genes = tiny()
    for g in range(4):
        ex = genes.exons[g]
        fwd = np.concatenate([np.arange(a, b + 1) for a, b in ex])
        if genes.strand[g]:
            fwd = fwd[::-1]
        pos = np.arange(1, len(fwd) + 1)
        assert np.array_equal(R.transcript_to_genome(genes, g, pos), fwd)


def test_breakpoints_hold_every_cdna_slide():
    cfg, mix, genes = tiny()
    lib = G.make_library(cfg, mix, genes, 11, 2000)
    fus = lib.fusions
    for f in range(len(fus.a)):
        allowed = R.breakpoints(genes, lib, f)
        seq = fus.seq(genes, f)
        a, b = genes.seq(fus.a[f]), genes.seq(fus.b[f])
        ba, bb = fus.break_a[f], fus.break_b[f]
        for k in range(-8, 9):
            joined = np.concatenate([a[:ba + k], b[bb - 1 + k:]])
            slides = len(joined) == len(seq) and (joined == seq).all()
            assert slides <= ((ba + k, bb + k) in allowed), (f, k)
        assert (ba, bb) in allowed


def test_genome_to_transcript_inverts_and_extends_exons():
    _, _, genes = tiny()
    for g in range(6):
        n = int(genes.lengths[g])
        pos = np.arange(1, n + 1)
        gpos = R.transcript_to_genome(genes, g, pos)
        back = [R.genome_to_transcript(genes, g, int(x))[0] for x in gpos]
        assert back == list(pos)
        # two bases into the intron past the first exon's end continue it
        first_end = int(genes.exons[g, 0, 1])
        step = -1 if genes.strand[g] else 1
        t = R.genome_to_transcript(genes, g, first_end)[0]
        assert t + 2 * step in R.genome_to_transcript(genes, g, first_end + 2)


def test_reference_answer_agrees_and_control_does_not():
    cfg, _, genes = tiny()
    mix = {"fusions": 50, "frags_per_fusion": 150, "decoy_share": 0.05}
    lib = G.make_library(cfg, mix, genes, 2 ** 32 + 3, 20000)
    exp = R.expected(lib, genes, cfg)
    own = compare.numbers(observe.from_expected(exp, genes), exp, genes)
    assert own["frontend_pairs_differ"] == own["fusion_disagreements"] == 0
    assert compare.judge([own])[0]
    answers = C.control_answers(lib, genes, cfg, exp)
    exact = compare.numbers(
        observe.from_expected(answers["exact_alignment"], genes), exp, genes)
    assert exact["frontend_pairs_differ"] > 0
    moved = compare.numbers(
        observe.from_expected(answers["breakpoint_moved"], genes), exp, genes)
    # every fusion missed and extra, in discover's clusters and in results
    assert moved["fusion_disagreements"] == 4 * mix["fusions"]
    assert moved["frontend_pairs_differ"] == 0
    assert not compare.judge([exact])[0] and not compare.judge([moved])[0]
