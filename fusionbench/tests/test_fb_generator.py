"""The generator: one seed, one library; the planted truth is what the
reads say."""

import json

import numpy as np

import generator as G
from conftest import BENCH, TINY_GENOME


def tiny():
    cfg = json.loads((BENCH / "configs" / "wts50.json").read_text())
    cfg["genome"].update(TINY_GENOME)
    mix = {"fusions": 8, "frags_per_fusion": 40, "decoy_share": 0.05}
    return cfg, mix, G.make_genome(cfg)[1]


def test_same_seed_same_library(tmp_path):
    cfg, mix, genes = tiny()
    seed = 2 ** 31 + 12345
    a = G.make_library(cfg, mix, genes, seed, 5000)
    b = G.make_library(cfg, mix, genes, seed, 5000)
    c = G.make_library(cfg, mix, genes, seed + 1, 5000)
    for k in ("kind", "fusion", "gene", "start", "flen", "side"):
        assert np.array_equal(getattr(a, k), getattr(b, k))
    assert not np.array_equal(a.start, c.start)
    fa = G.write_library(a, genes, seed, tmp_path / "a")
    fb = G.write_library(b, genes, seed, tmp_path / "b")
    assert fa[0].read_bytes() == fb[0].read_bytes()
    assert fa[1].read_bytes() == fb[1].read_bytes()


def test_genome_fixed_by_configuration():
    cfg, _, genes = tiny()
    again = G.make_genome(cfg)[1]
    assert np.array_equal(genes.cdna, again.cdna)
    assert len(genes.chrom) >= 16
    lens = genes.exons[:, :, 1] - genes.exons[:, :, 0] + 1
    assert lens.min() >= 500 and lens.max() <= 900
    introns = genes.exons[:, 1:, 0] - genes.exons[:, :-1, 1] - 1
    assert introns.min() >= 800 and introns.max() <= 1500


def test_planted_truth_matches_reads():
    cfg, mix, genes = tiny()
    seed = 99
    lib = G.make_library(cfg, mix, genes, seed, 4000)
    r1, r2 = G.library_reads(lib, genes, seed)
    L = lib.read_len
    counts = np.bincount(lib.kind, minlength=3)
    assert counts[G.KIND_FUSION] == 8 * 40
    assert counts[G.KIND_DECOY] == 200
    assert counts.sum() == 4000
    fus = lib.fusions
    assert (genes.chrom[fus.a] != genes.chrom[fus.b]).all()
    assert len(set(fus.a) | set(fus.b)) == 16
    for i in range(lib.n_pairs):
        if lib.kind[i] == G.KIND_BACKGROUND:
            seq = genes.seq(lib.gene[i])
            s = lib.start[i] - 1
            assert (r1[i] == seq[s:s + L]).all()
            e = s + lib.flen[i]
            assert (G.revcomp(r2[i]) == seq[e - L:e]).all()
        elif lib.kind[i] == G.KIND_FUSION:
            f = lib.fusion[i]
            seq = fus.seq(genes, f)
            s = lib.start[i] - 1
            assert s < fus.break_a[f] + 40 and \
                s + lib.flen[i] > fus.break_a[f]
            assert (r1[i] == seq[s:s + L]).all()
        else:
            f, g = lib.fusion[i], lib.gene[i]
            anchor = r1[i] if lib.side[i] == 0 else G.revcomp(r1[i])
            s = lib.start[i] - 1
            assert (anchor == genes.seq(g)[s:s + L]).all()
            if lib.side[i] == 0:
                assert g == fus.a[f] and s + L <= fus.break_a[f]
            else:
                assert g == fus.b[f] and s + 1 >= fus.break_b[f]
