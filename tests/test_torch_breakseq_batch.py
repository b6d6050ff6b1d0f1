"""The port's batched breakseq (``defuse_tpu_torch.align.breakseq``) against
the reference's one-query-at-a-time aligner (``defuse_tpu.align.breakseq``).

Every ``breakpoints.*.psl`` file that ``align_breakpoints`` writes must be
the reference's byte for byte, for each kind of input the aligner meets:
spliced chains, minus-strand queries, diverged paralogs, a pseudogene,
``N`` bases, short, ``"N"`` and empty queries, repeats past the 64-hit cap
of a seed, an EST target, an index of 10-mers and no queries at all.  Each
case runs on indices built in memory (the whole key table searched) and on
indices saved and mapped back (the search narrowed by the prefix table)."""

import pathlib
import random

import pytest

from defuse_tpu.align import breakseq as ref_breakseq
from defuse_tpu.align.seedindex import SeedIndex as RefSeedIndex
from defuse_tpu_torch.align import breakseq
from defuse_tpu_torch.align.seedindex import SeedIndex
from defuse_tpu_torch.core.types import revcomp

BASES = "ACGT"


def rnd(rng, n):
    return "".join(rng.choice(BASES) for _ in range(n))


def mutate(rng, seq, identity):
    out = list(seq)
    for i in range(len(out)):
        if rng.random() > identity:
            out[i] = rng.choice([c for c in BASES if c != out[i]])
    return "".join(out)


def gene_targets(rng, genome):
    """cdna, exons and cds sets of two genes, three exons each, on the
    first two sequences of ``genome``."""
    c1, c2 = list(genome.values())[:2]
    exons = {}
    cdna, cds = {}, {}
    for g, chrom in (("GA", c1), ("GB", c2)):
        at = rng.randrange(1000, 3000)
        parts = []
        for e in range(3):
            parts.append(chrom[at:at + rng.randrange(150, 400)])
            exons[f"{g}|T{g}|{e}"] = parts[-1]
            at += len(parts[-1]) + rng.randrange(500, 2000)
        cdna[f"{g}|T{g}"] = "".join(parts)
        cds[f"{g}|T{g}"] = "".join(parts)[30:-30]
    return cdna, exons, cds


def fusion_queries(rng, cdna, n):
    a, b = list(cdna.values())[:2]
    out = {}
    for cid in range(n):
        i = rng.randrange(60, len(a) - 60)
        j = rng.randrange(60, len(b) - 60)
        out[cid] = a[i - rng.randrange(40, 60):i] + "|" + \
            b[j:j + rng.randrange(40, 60)]
    return out


def case_spliced(rng):
    genome = {"1": rnd(rng, 20000), "2": rnd(rng, 20000)}
    cdna, exons, cds = gene_targets(rng, genome)
    seqs = fusion_queries(rng, cdna, 8)
    # whole transcripts: chains across both introns
    seqs[20] = cdna["GA|TGA"]
    seqs[21] = cdna["GB|TGB"]
    return seqs, {"genome": genome, "cdna": cdna, "exons": exons,
                  "cds": cds}, 16


def case_minus_strand(rng):
    genome = {"1": rnd(rng, 12000), "2": rnd(rng, 9000)}
    cdna, exons, cds = gene_targets(rng, genome)
    seqs = {cid: revcomp(q.replace("|", "")) for cid, q in
            fusion_queries(rng, cdna, 6).items()}
    seqs[9] = revcomp(genome["2"][4000:4400])
    return seqs, {"genome": genome, "cdna": cdna, "exons": exons}, 16


def case_paralogs(rng):
    flank1, flank2 = rnd(rng, 200), rnd(rng, 200)
    genome = {"1": rnd(rng, 6000) + flank1 + rnd(rng, 6000),
              "3": rnd(rng, 6000) + flank2 + rnd(rng, 6000)}
    for p in (0.85, 0.9, 0.95):
        genome[f"p{p}"] = rnd(rng, 3000) + mutate(rng, flank1, p) \
            + rnd(rng, 8000) + mutate(rng, flank2, p) + rnd(rng, 3000)
    seqs = {0: flank1 + "|" + flank2, 1: flank1[50:] + "|" + flank2[:120],
            2: mutate(rng, flank1 + flank2, 0.9)}
    cdna = {"GA|TA": mutate(rng, flank1, 0.92) + rnd(rng, 100),
            "GB|TB": flank2}
    return seqs, {"genome": genome, "cdna": cdna}, 16


def case_pseudogene(rng):
    e1, e2, e3 = rnd(rng, 300), rnd(rng, 280), rnd(rng, 250)
    gene = e1 + rnd(rng, 1500) + e2 + rnd(rng, 2500) + e3
    genome = {"1": rnd(rng, 4000) + gene + rnd(rng, 4000),
              "2": rnd(rng, 3000) + e1 + e2 + e3 + rnd(rng, 3000)}
    seqs = {0: e1[-180:] + "|" + e2[:180], 1: e2[-100:] + "|" + e3[:100]}
    exons = {"G|T|0": e1, "G|T|1": e2, "G|T|2": e3}
    return seqs, {"genome": genome, "exons": exons}, 16


def case_n_bases(rng):
    genome = {"1": rnd(rng, 9000), "2": rnd(rng, 9000)}
    cdna, exons, cds = gene_targets(rng, genome)
    seqs = fusion_queries(rng, cdna, 6)
    for cid in list(seqs):
        q = list(seqs[cid])
        for _ in range(cid + 1):
            i = rng.randrange(len(q))
            if q[i] != "|":
                q[i] = "N"
        seqs[cid] = "".join(q)
    seqs[7] = "N" * 20 + genome["1"][2000:2100] + "NNNN" + \
        genome["2"][100:180].lower()
    # N in the target too: equal codes count as a match in the extension
    genome["3"] = genome["1"][5000:5300] + "N" * 12 + genome["1"][5312:6000]
    seqs[8] = genome["1"][5000:5600]
    return seqs, {"genome": genome, "cdna": cdna, "cds": cds}, 16


def case_short_queries(rng):
    genome = {"1": rnd(rng, 6000)}
    seqs = {0: genome["1"][100:105], 1: genome["1"][200:215],
            2: genome["1"][300:316], 3: genome["1"][400:417],
            4: genome["1"][500:508] + "|" + genome["1"][900:907],
            5: genome["1"][1000:1300]}
    return seqs, {"genome": genome, "cdna": {"G|T": genome["1"][:2000]}}, 16


def case_n_and_empty_rows(rng):
    genome = {"1": rnd(rng, 6000), "2": rnd(rng, 6000)}
    seqs = {0: "N", 1: "", 2: "|", 3: genome["1"][100:250] + "|" +
            genome["2"][3000:3150], 5: "N", 7: "NNNN"}
    return seqs, {"genome": genome}, 16


def case_repeat_past_the_cap(rng):
    element = rnd(rng, 60)
    genome = {"1": "".join(rnd(rng, 150) + mutate(rng, element, 0.97)
                           for _ in range(60)),
              "2": "".join(rnd(rng, 120) + element for _ in range(80))}
    seqs = {0: rnd(rng, 40) + element + "|" + rnd(rng, 40),
            1: genome["1"][1000:1200] + "|" + element + element,
            2: revcomp(element) + genome["2"][:100]}
    return seqs, {"genome": genome, "cdna": {"G|T": element * 3}}, 16


def case_est_target(rng):
    genome = {"1": rnd(rng, 15000), "2": rnd(rng, 15000)}
    cdna, exons, _cds = gene_targets(rng, genome)
    est = {"EST1": exons["GA|TGA|0"] + exons["GA|TGA|1"],
           "EST2": exons["GB|TGB|1"][20:] + exons["GB|TGB|2"],
           "EST3": revcomp(cdna["GA|TGA"])}
    seqs = fusion_queries(rng, cdna, 6)
    return seqs, {"genome": genome, "est": est, "exons": exons}, 16


def case_seed_len_10(rng):
    genome = {"1": rnd(rng, 5000), "2": rnd(rng, 5000)}
    cdna, exons, cds = gene_targets(rng, genome)
    seqs = fusion_queries(rng, cdna, 6)
    seqs[10] = genome["1"][100:112]
    return seqs, {"genome": genome, "cdna": cdna, "exons": exons,
                  "cds": cds}, 10


def case_no_queries(rng):
    genome = {"1": rnd(rng, 3000)}
    return {}, {"genome": genome, "cdna": {"G|T": genome["1"][:900]}}, 16


CASES = {f.__name__[5:]: f for f in (
    case_spliced, case_minus_strand, case_paralogs, case_pseudogene,
    case_n_bases, case_short_queries, case_n_and_empty_rows,
    case_repeat_past_the_cap, case_est_target, case_seed_len_10,
    case_no_queries)}


def indices(cls, sets, k, form, where):
    """One index a target set, built in memory or saved and mapped back."""
    out = {}
    for name, seqs in sets.items():
        index = cls(seqs, seed_len=k)
        if form == "mapped":
            prefix = str(where / f"{name}.seedidx")
            index.save(prefix)
            index = cls.load(prefix)
            assert index.prefix_table is not None
        out[name] = index
    return out


@pytest.mark.parametrize("form", ["in_memory", "mapped"])
@pytest.mark.parametrize("case", list(CASES))
def test_breakpoint_files_are_the_references(case, form, tmp_path):
    seqs, sets, k = CASES[case](random.Random(sorted(CASES).index(case)))
    written = {}
    for tag, mod, cls in (("ref", ref_breakseq, RefSeedIndex),
                          ("port", breakseq, SeedIndex)):
        (tmp_path / tag).mkdir()
        targets = indices(cls, sets, k, form, tmp_path / tag)
        written[tag] = mod.align_breakpoints(seqs, targets,
                                             str(tmp_path / tag))
    assert sorted(written["port"]) == sorted(written["ref"])
    for label, path in written["ref"].items():
        want = pathlib.Path(path).read_bytes()
        assert pathlib.Path(written["port"][label]).read_bytes() == want, \
            label
    if case == "repeat_past_the_cap":
        cap = sets["genome"]["2"].count(sets["cdna"]["G|T"][:60])
        assert cap > breakseq.MAX_SEED_HITS
    if case == "no_queries":
        assert all(pathlib.Path(p).stat().st_size == 0
                   for p in written["port"].values())
    elif case != "n_and_empty_rows":
        assert pathlib.Path(written["port"]["genome"]).stat().st_size > 0


@pytest.mark.parametrize("gap", [30, 500000])
@pytest.mark.parametrize("case", ["spliced", "minus_strand", "paralogs",
                                  "seed_len_10"])
def test_align_breakseq_one_query_is_the_references(case, gap):
    """``align_breakseq`` keeps the reference's name and signature, as the
    one-query case of the batch: the same rows for each query."""
    seqs, sets, k = CASES[case](random.Random(sorted(CASES).index(case)))
    port = SeedIndex(sets["genome"], seed_len=k)
    ref = RefSeedIndex(sets["genome"], seed_len=k)
    n_rows = 0
    for cid in sorted(seqs):
        seq = seqs[cid].replace("|", "")
        want = [r.format() for r in ref_breakseq.align_breakseq(
            ref, str(cid), seq, max_gap=gap, spliced=gap > 1000)]
        got = breakseq.align_breakseq(port, str(cid), seq, max_gap=gap,
                                      spliced=gap > 1000)
        assert [r.format() for r in got] == want, cid
        assert all(isinstance(r, breakseq.PslRow) for r in got)
        n_rows += len(got)
    assert n_rows > 0


def test_counts_are_what_the_pass_carried(tmp_path):
    """``counts`` gains one pass's queries (the non-``N`` rows), seeds,
    hits, blocks and rows; the genome's two files come from one pass."""
    seqs, sets, k = CASES["n_and_empty_rows"](random.Random(3))
    seqs = {**seqs, **{10 + c: q for c, q in
                       CASES["spliced"](random.Random(4))[0].items()}}
    counts = {}
    paths = breakseq.align_breakpoints(
        seqs, {"genome": SeedIndex(sets["genome"], seed_len=k)},
        str(tmp_path), counts=counts)
    assert sorted(counts) == ["blocks", "hits", "queries", "rows", "seeds"]
    assert counts["queries"] == sum(
        1 for q in seqs.values() if q.replace("|", "") not in ("", "N"))
    assert counts["rows"] == sum(
        len(pathlib.Path(p).read_text().splitlines())
        for p in paths.values())
    assert counts["seeds"] >= counts["queries"]
    assert counts["hits"] >= counts["blocks"] > 0
