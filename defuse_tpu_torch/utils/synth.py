"""Seeded synthetic inputs for the port: the bench dataset and the kernels'
test cases.

The port's own copy of what it needs from the repository's dataset makers,
so that the smoke run on the card and the CPU tests share inputs without
importing anything outside the package:

* ``build_dataset`` with the discover settings it was made for (``MEAN``,
  ``STD``, ``PREC``, ``MINCL``, ``MINREAD``, ``MAXREAD``): the multi-fusion
  dataset of ``bench.py``, file for file;
* ``Gene``, ``SynthDataset``, ``random_seq``, ``make_dataset``,
  ``write_dataset``, ``write_gtf``, ``write_genome_fasta``,
  ``write_repeats``: the synthetic-genome helpers of ``tests/synthdata.py``
  that it needs (``make_dataset``: the one-fusion dataset of the multi-process
  dryrun in ``entry.py``);
* ``write_run_config``, ``planted_pairs``, ``deal_fastq``: what a whole
  ``run`` needs beside the reads (a config file naming the genome, the gene
  models and the repeats, from which ``create-ref`` derives the dataset
  directory), the gene pairs the reads were planted with, and a library
  dealt out into smaller ones;
* ``sweep_inputs``, ``edge_case``, ``screen_case``, ``verify_case``,
  ``frontend_config``: the seeded cases that hold the kernels' plain versions against the JAX
  package on the CPU and the kernels against their plain versions on the
  card.
"""

from __future__ import annotations

import dataclasses
import random

import numpy as np
import torch

from ..align.split_dp import accept_threshold
from ..config import Config
from ..core.types import revcomp
from ..io.fasta import write_fasta
from ..ops.split_dp_batch import pad_batch

MEAN, STD, PREC, MINCL = 200.0, 20.0, 0.95, 3
MINREAD = MAXREAD = 50
READ_LEN = 50  # make_dataset's reads

N_FUSIONS = 96
FRAGS_PER_FUSION = 150
N_BACKGROUND = 40000
DECOYS_PER_FUSION = 400

SWEEP = ((60, 24), (90, 24), (100, 24), (130, 64), (128, 64), (257, 64),
         (384, 64))

# name: (R, L, B, kind).  What a kernel that follows the flank width, packs
# two DPs into int16 halves and right-aligns them can get wrong: R + 1 not a
# multiple of 32, flanks much shorter than the table, flank lengths 0 and
# R, read lengths 0 and L, and the int16 range at the longest read (every
# cell a match: the largest scores; every cell a mismatch: the smallest).
EDGE_CASES = {
    "R33": (33, 24, 16, "random"),
    "R220": (220, 64, 16, "random"),
    "R257": (257, 64, 16, "random"),
    "R300": (300, 64, 16, "random"),
    "R1023": (1023, 24, 6, "random"),
    "short_flanks": (512, 64, 16, "short"),
    "one_column": (31, 24, 16, "random"),
    "L1024_match": (1023, 1024, 4, "match"),
    "L1024_mismatch": (1023, 1024, 4, "mismatch"),
}


@dataclasses.dataclass
class Gene:
    name: str
    transcript: str
    chromosome: str
    strand: int
    exons: list[tuple[int, int]]

    def cdna(self, genome: dict[str, str]) -> str:
        chrom = genome[self.chromosome]
        seq = "".join(chrom[s - 1:e] for s, e in self.exons)
        if self.strand == 1:
            seq = revcomp(seq)
        return seq

    def transcript_to_genome(self, pos: int) -> int:
        """1-based transcript position -> genomic position."""
        length = sum(e - s + 1 for s, e in self.exons)
        if self.strand == 1:
            pos = length - pos + 1
        off = 0
        for s, e in self.exons:
            if pos <= off + (e - s + 1):
                return s + (pos - off - 1)
            off += e - s + 1
        raise ValueError(pos)


def random_seq(rng: random.Random, n: int) -> str:
    nprng = np.random.default_rng(rng.getrandbits(63))
    return nprng.integers(0, 4, n, dtype=np.uint8).astype("uint8") \
        .choose(np.frombuffer(b"ACGT", dtype=np.uint8)) \
        .tobytes().decode()


@dataclasses.dataclass
class SynthDataset:
    genome: dict[str, str]
    genes: list[Gene]
    fusion: tuple[str, int, str, int]  # transcriptA, breakA, transcriptB, breakB
    fusion_seq: str
    reads1: list[str]
    reads2: list[str]
    sam_rows: list[tuple]  # (fragment, read_end, ref, strand, pos, seq)

    def gene_by_transcript(self, t):
        return next(g for g in self.genes if g.transcript == t)


def make_dataset(seed: int = 7, n_fusion_frags: int = 120,
                 n_background_frags: int = 60,
                 frag_mean: float = 200.0, frag_std: float = 20.0,
                 fusion_pair: tuple[str, str] = ("TA", "TB"),
                 break_a: int = 1700, break_b: int = 1500):
    rng = random.Random(seed)
    genome = {
        "1": random_seq(rng, 120000),
        "2": random_seq(rng, 120000),
    }

    genes = [
        Gene("GA", "TA", "1", 0,
             [(20000, 20800), (22000, 22900), (24000, 24700),
              (26000, 26900)]),
        Gene("GB", "TB", "2", 0,
             [(40000, 40900), (42000, 42800), (44000, 44900),
              (46000, 46800)]),
        Gene("GC", "TC", "1", 1,
             [(60000, 60700), (62000, 62600), (64000, 64800)]),
        Gene("GD", "TD", "2", 1,
             [(80000, 80600), (82000, 82700), (84000, 84500)]),
    ]

    by_transcript = {g.transcript: g for g in genes}
    ga = by_transcript[fusion_pair[0]]
    gb = by_transcript[fusion_pair[1]]
    cdna_a = ga.cdna(genome)
    cdna_b = gb.cdna(genome)

    # fusion: A[1..break_a] + B[break_b..] (transcript space)
    fusion_seq = cdna_a[:break_a] + cdna_b[break_b - 1:]

    reads1: list[str] = []
    reads2: list[str] = []
    sam_rows: list[tuple] = []

    def emit_alignments(frag_id, read_end, tpos_start, gene, read_seq,
                        read_from_plus):
        """Emit cdna + (when intra-exon) genome alignment rows for a read
        lying entirely within ``gene``'s transcript at 1-based transcript
        position ``tpos_start``.  ``read_from_plus``: read sequence equals
        transcript-forward slice (strand + on cdna)."""
        ref_cdna = f"{gene.name}|{gene.transcript}"
        strand = 0 if read_from_plus else 1
        sam_rows.append((frag_id, read_end, ref_cdna, strand, tpos_start,
                         read_seq))
        # genome alignment when contained in a single exon
        g_start = gene.transcript_to_genome(tpos_start)
        g_end = gene.transcript_to_genome(tpos_start + READ_LEN - 1)
        if abs(g_end - g_start) == READ_LEN - 1:
            gs = min(g_start, g_end)
            if gene.strand == 1:
                g_strand = 1 - strand
            else:
                g_strand = strand
            sam_rows.append((frag_id, read_end, gene.chromosome, g_strand,
                             gs, read_seq))

    frag_id = 0

    # --- fusion-spanning fragments --------------------------------------
    for _ in range(n_fusion_frags):
        flen = max(2 * READ_LEN,
                   int(rng.gauss(frag_mean, frag_std)))
        start = rng.randint(max(1, break_a - flen + 10),
                            min(break_a + 40, len(fusion_seq) - flen))
        frag = fusion_seq[start - 1:start - 1 + flen]
        r1 = frag[:READ_LEN]
        r2 = revcomp(frag[-READ_LEN:])
        reads1.append(r1)
        reads2.append(r2)

        # read 1 forward at fusion pos [start, start+49]
        r1_end = start + READ_LEN - 1
        r2_start = start + flen - READ_LEN
        r2_end = start + flen - 1
        if r1_end <= break_a:
            emit_alignments(frag_id, 0, start, ga, r1, True)
        elif start > break_a:
            tb_pos = start - break_a + break_b - 1
            emit_alignments(frag_id, 0, tb_pos, gb, r1, True)
        # else: crosses the breakpoint -> unaligned (split candidate)

        if r2_start > break_a:
            tb_pos = r2_start - break_a + break_b - 1
            emit_alignments(frag_id, 1, tb_pos, gb, r2, False)
        elif r2_end <= break_a:
            emit_alignments(frag_id, 1, r2_start, ga, r2, False)
        # else crosses breakpoint
        frag_id += 1

    # --- concordant background fragments --------------------------------
    for _ in range(n_background_frags):
        gene = rng.choice(genes)
        cdna = gene.cdna(genome)
        flen = max(2 * READ_LEN, int(rng.gauss(frag_mean, frag_std)))
        if flen >= len(cdna):
            flen = len(cdna) - 1
        start = rng.randint(1, len(cdna) - flen)
        frag = cdna[start - 1:start - 1 + flen]
        r1 = frag[:READ_LEN]
        r2 = revcomp(frag[-READ_LEN:])
        reads1.append(r1)
        reads2.append(r2)
        emit_alignments(frag_id, 0, start, gene, r1, True)
        emit_alignments(frag_id, 1, start + flen - READ_LEN, gene, r2,
                        False)
        frag_id += 1

    return SynthDataset(genome, genes, ("TA", break_a, "TB", break_b),
                        fusion_seq, reads1, reads2, sam_rows)


def write_dataset(ds: SynthDataset, outdir):
    """Write reference.fa(.fai), cdna.regions, fastqs, improper.sam,
    spanning compact file.  Returns a dict of paths."""
    outdir.mkdir(parents=True, exist_ok=True)
    paths = {}

    sequences = dict(ds.genome)
    for gene in ds.genes:
        sequences[f"{gene.name}|{gene.transcript}"] = \
            gene.cdna(ds.genome) + "A" * 50
    paths["reference"] = outdir / "reference.fa"
    write_fasta(str(paths["reference"]), sequences)

    paths["exons"] = outdir / "cdna.regions"
    with open(paths["exons"], "w") as out:
        for gene in ds.genes:
            fields = [gene.name, gene.transcript, gene.chromosome,
                      "+" if gene.strand == 0 else "-"]
            for s, e in gene.exons:
                fields += [str(s), str(e)]
            out.write("\t".join(fields) + "\n")

    paths["fastq1"] = outdir / "reads.1.fastq"
    paths["fastq2"] = outdir / "reads.2.fastq"
    for path, reads, end in ((paths["fastq1"], ds.reads1, 1),
                             (paths["fastq2"], ds.reads2, 2)):
        with open(path, "w") as out:
            for i, seq in enumerate(reads):
                out.write(f"@{i}/{end}\n{seq}\n+\n{'I' * len(seq)}\n")

    paths["improper"] = outdir / "improper.sam"
    with open(paths["improper"], "w") as out:
        for (frag, read_end, ref, strand, pos, seq) in ds.sam_rows:
            flag = (0x10 if strand else 0)
            out.write(f"{frag}/{read_end + 1}\t{flag}\t{ref}\t{pos}\t255\t"
                      f"{len(seq)}M\t*\t0\t0\t{seq}\t{'I' * len(seq)}\n")

    # spanning file: both-ends-aligned fragments, compact format
    paths["spanning"] = outdir / "spanning.compact"
    ends_seen: dict[int, set[int]] = {}
    for (frag, read_end, *_rest) in ds.sam_rows:
        ends_seen.setdefault(frag, set()).add(read_end)
    with open(paths["spanning"], "w") as out:
        for (frag, read_end, ref, strand, pos, seq) in ds.sam_rows:
            if len(ends_seen[frag]) < 2:
                continue
            out.write(f"{frag}\t{read_end}\t{ref}\t"
                      f"{'-' if strand else '+'}\t{pos}\t"
                      f"{pos + len(seq) - 1}\n")

    return paths


def write_gtf(ds: SynthDataset, path) -> None:
    """GTF gene models for the synthetic genes (exons + CDS covering the
    interior exons, so UTR/ORF features are exercised)."""
    with open(path, "w") as out:
        for gene in ds.genes:
            strand = "+" if gene.strand == 0 else "-"
            attrs = (f'gene_id "{gene.name}"; '
                     f'transcript_id "{gene.transcript}"; '
                     f'gene_name "{gene.name}_name";')
            for i, (s, e) in enumerate(gene.exons):
                out.write(f"{gene.chromosome}\tsynth\texon\t{s}\t{e}\t.\t"
                          f"{strand}\t.\t{attrs}\n")
                # CDS: all but the first and last exon (UTR ends)
                if 0 < i < len(gene.exons) - 1:
                    out.write(f"{gene.chromosome}\tsynth\tCDS\t{s}\t{e}"
                              f"\t.\t{strand}\t.\t{attrs}\n")


def write_genome_fasta(ds: SynthDataset, path) -> None:
    write_fasta(str(path), dict(ds.genome))


def write_repeats(ds: SynthDataset, path, seed=17, n=300) -> None:
    rng = random.Random(seed)
    with open(path, "w") as out:
        for _ in range(n):
            chrom = rng.choice(list(ds.genome))
            start = rng.randint(0, len(ds.genome[chrom]) - 2000)
            end = start + rng.randint(100, 1900)
            out.write(f"{chrom}\t{start}\t{end}\tSynthRep\n")


def write_run_config(ds: SynthDataset, tmp, **overrides):
    """Write what ``create-ref`` and ``run`` read for the synthetic genome
    ``ds`` under ``tmp``: ``genome.fa``, ``genes.gtf``, ``repeats.regions``
    and ``config.txt``, whose derived files live under the dataset
    directory given on the command line.  Returns the config's path.
    ``overrides`` replace or add ``key = value`` lines."""
    tmp.mkdir(parents=True, exist_ok=True)
    write_gtf(ds, tmp / "genes.gtf")
    write_genome_fasta(ds, tmp / "genome.fa")
    write_repeats(ds, tmp / "repeats.regions")
    values = {
        "genome_fasta": tmp / "genome.fa",
        "gene_models": tmp / "genes.gtf",
        "gene_biotypes": "synth",
        "chromosomes": ",".join(ds.genome),
        "span_count_threshold": 3,
        "repeats_regions": tmp / "repeats.regions",
        "dataset_prefix": "$(dataset_directory)/defuse",
        "cdna_regions": "$(dataset_prefix).cdna.regions",
        "cdna_fasta": "$(dataset_prefix).cdna.fa",
        "exons_fasta": "$(dataset_prefix).exons.fa",
        "cds_fasta": "$(dataset_prefix).cds.fa",
        "reference_fasta": "$(dataset_prefix).reference.fa",
        "rrna_fasta": "$(dataset_prefix).rrna.fa",
        "ig_gene_list": "$(dataset_prefix).ig.gene.list",
    } | overrides
    config = tmp / "config.txt"
    config.write_text("".join(f"{k} = {v}\n" for k, v in values.items()))
    return config


def planted_pairs(ds: SynthDataset) -> set:
    """The gene pairs ``build_dataset`` joined: genes 2k and 2k+1."""
    names = [g.name for g in ds.genes]
    return {frozenset(names[i:i + 2]) for i in range(0, len(names), 2)}


def deal_fastq(src, dsts) -> None:
    """Deal the records of the fastq ``src`` out to the files ``dsts`` in
    turn, so each gets an even share of every fusion's fragments."""
    outs = [open(d, "w") for d in dsts]
    try:
        with open(src) as fin:
            for i, line in enumerate(fin):
                outs[(i // 4) % len(outs)].write(line)
    finally:
        for fh in outs:
            fh.close()


def build_dataset(tmp, n_fusions=N_FUSIONS, n_background=N_BACKGROUND):
    """Multi-fusion dataset: N_FUSIONS gene pairs on a synthetic genome.
    Fewer ``n_fusions`` (with their decoys) or ``n_background`` pairs cut it
    down for the routes that run in Python."""
    rng = random.Random(1234)
    chrom_len = 2_000_000
    genome = {"1": random_seq(rng, chrom_len), "2": random_seq(rng, chrom_len)}

    genes = []
    pos = {"1": 30000, "2": 30000}
    for gi in range(2 * n_fusions):
        chrom = "1" if gi % 2 == 0 else "2"
        strand = rng.randint(0, 1)
        exons = []
        p = pos[chrom]
        for _ in range(4):
            length = rng.randint(500, 900)
            exons.append((p, p + length - 1))
            p += length + rng.randint(800, 1500)
        pos[chrom] = p + 10000
        genes.append(Gene(f"G{gi}", f"T{gi}", chrom, strand, exons))

    reads1, reads2, sam_rows = [], [], []
    frag_id = 0
    fusions = []

    def emit(frag, read_end, tpos, gene, seq, from_plus):
        ref_cdna = f"{gene.name}|{gene.transcript}"
        strand = 0 if from_plus else 1
        sam_rows.append((frag, read_end, ref_cdna, strand, tpos, seq))
        g_start = gene.transcript_to_genome(tpos)
        g_end = gene.transcript_to_genome(tpos + 49)
        if abs(g_end - g_start) == 49:
            gs = min(g_start, g_end)
            g_strand = (1 - strand) if gene.strand == 1 else strand
            sam_rows.append((frag, read_end, gene.chromosome, g_strand, gs,
                             seq))

    for fi in range(n_fusions):
        ga, gb = genes[2 * fi], genes[2 * fi + 1]
        ca, cb = ga.cdna(genome), gb.cdna(genome)
        break_a = rng.randint(800, len(ca) - 400)
        break_b = rng.randint(400, len(cb) - 800)
        fusion_seq = ca[:break_a] + cb[break_b - 1:]
        fusions.append((ga, gb, break_a, break_b, fusion_seq))
        for _ in range(FRAGS_PER_FUSION):
            flen = max(100, int(rng.gauss(MEAN, STD)))
            lo = max(1, break_a - flen + 10)
            hi = min(break_a + 40, len(fusion_seq) - flen)
            if hi <= lo:
                continue
            start = rng.randint(lo, hi)
            frag = fusion_seq[start - 1:start - 1 + flen]
            r1, r2 = frag[:50], revcomp(frag[-50:])
            reads1.append(r1)
            reads2.append(r2)
            r1_end = start + 49
            r2_start = start + flen - 50
            if r1_end <= break_a:
                emit(frag_id, 0, start, ga, r1, True)
            elif start > break_a:
                emit(frag_id, 0, start - break_a + break_b - 1, gb, r1, True)
            if r2_start > break_a:
                emit(frag_id, 1, r2_start - break_a + break_b - 1, gb, r2,
                     False)
            elif r2_start + 49 <= break_a:
                emit(frag_id, 1, r2_start, ga, r2, False)
            frag_id += 1

    # decoy improper reads: mismapped/chimeric-artifact noise at the
    # fusion loci — nominated as split candidates by both toolchains,
    # rejected by the DP accept threshold (realistic candidate accept
    # rates are low; this is where the device screen pays off).  One
    # read end only, so they never enter the spanning/clustering input.
    for di in range(n_fusions * DECOYS_PER_FUSION):
        ga, gb, break_a, break_b, _fseq = fusions[di % n_fusions]
        gene, brk = (ga, break_a) if di % 2 == 0 else (gb, break_b)
        cdna_len = len(gene.cdna(genome))
        pos = min(max(1, brk + rng.randint(-int(MEAN), int(MEAN))),
                  max(1, cdna_len - 49))
        junk = random_seq(rng, 50)
        reads1.append(junk)
        reads2.append(random_seq(rng, 50))
        sam_rows.append((frag_id, 0, f"{gene.name}|{gene.transcript}",
                         di % 2, pos, junk))
        frag_id += 1

    for _ in range(n_background):
        gene = rng.choice(genes)
        cdna = gene.cdna(genome)
        flen = max(100, int(rng.gauss(MEAN, STD)))
        if flen >= len(cdna):
            flen = len(cdna) - 1
        start = rng.randint(1, len(cdna) - flen)
        frag = cdna[start - 1:start - 1 + flen]
        reads1.append(frag[:50])
        reads2.append(revcomp(frag[-50:]))
        emit(frag_id, 0, start, gene, frag[:50], True)
        emit(frag_id, 1, start + flen - 50, gene, revcomp(frag[-50:]),
             False)
        frag_id += 1

    ds = SynthDataset(genome, genes, ("", 0, "", 0), "", reads1, reads2,
                      sam_rows)
    paths = write_dataset(ds, tmp)
    # production ingest (index_paired_fastq contract): renamed fastqs +
    # reads.fqi, exactly as the pipeline stages preceding discover
    # produce them in both toolchains (index_paired_fastq.pl runs before
    # dosplitalign in the reference).  Both measured runs then read the
    # same renamed files; ours may additionally use the byte-offset
    # index for selective record preads — the reference's ReadIndex has
    # the same .fqi available.
    try:
        from ..cluster import native as _native
        if _native.available():
            ing = tmp / "ing"
            if _native.ingest_fastq(str(paths["fastq1"]),
                                    str(paths["fastq2"]),
                                    str(ing)) is not None:
                paths["fastq1"] = ing / "reads.1.fastq"
                paths["fastq2"] = ing / "reads.2.fastq"
    except Exception:
        pass
    return ds, paths, frag_id


def tensors(*arrays):
    return [torch.from_numpy(np.ascontiguousarray(a)) for a in arrays]


def rand_seq(rng, n):
    return "".join(rng.choice("ACGT") for _ in range(n))


def sweep_inputs(R, L, seed=7, B=16):
    """Random codes at (R, L) with zero-length flanks and reads included."""
    rng = np.random.default_rng(seed + R * 1000 + L)
    refs = rng.integers(1, 5, (B, R)).astype(np.uint8)
    rl = rng.integers(0, R + 1, B).astype(np.int32)
    reads = rng.integers(1, 5, (B, L)).astype(np.uint8)
    ql = rng.integers(0, L + 1, B).astype(np.int32)
    rl[0], ql[1], rl[2], ql[2] = 0, 0, R, L
    for b in range(3, B, 2):  # exact substrings so rows clear the anchor
        n = min(rl[b], ql[b])
        s = rng.integers(0, rl[b] - n + 1)
        reads[b, :n] = refs[b, s:s + n]
    return refs, rl, reads, ql


def edge_case(name, seed=11):
    """The case ``EDGE_CASES[name]``: (row-maxima inputs, screen inputs).

    Row maxima: (refs, ref_lens, reads, read_lens) with flank lengths 0 and
    R and read lengths 0 and L among the rows.  Screen: the same flanks as
    the unique-flank table (the second flank of pair k is flank B-1-k, kept
    reversed), each read against a random pair, every other read a planted
    junction (a flank-1 tail then a flank-2 head)."""
    from ..convert import screen_min_scores
    R, L, B, kind = EDGE_CASES[name]
    rng = np.random.default_rng(seed + R * 1000 + L)
    refs = rng.integers(1, 5, (B, R)).astype(np.uint8)
    reads = rng.integers(1, 5, (B, L)).astype(np.uint8)
    rl = rng.integers(0, R + 1, B).astype(np.int32)
    ql = rng.integers(0, L + 1, B).astype(np.int32)
    if kind == "short":
        rl = rng.integers(0, R // 8, B).astype(np.int32)
    if kind in ("random", "short"):
        rl[0], ql[0], rl[1], ql[2], rl[3], ql[3] = R, L, 0, 0, R, 0
        for b in range(4, B, 2):  # exact substrings: rows clear the anchor
            n = min(rl[b], ql[b])
            s = rng.integers(0, rl[b] - n + 1)
            reads[b, :n] = refs[b, s:s + n]
    else:
        rl[:], ql[:] = R, L
        if kind == "match":
            reads[:, :min(R, L)] = refs[:, :min(R, L)]
        else:
            refs[:], reads[:] = 1, 2

    u2r, ulen2 = refs[::-1].copy(), rl[::-1].copy()
    idx = rng.integers(0, B, B).astype(np.int32)
    sreads = reads.copy()
    for b in range(0, B, 2):
        k, n = int(idx[b]), int(ql[b])
        a = n // 2
        if rl[k] >= a and ulen2[k] >= n - a:
            sreads[b, :a] = refs[k, rl[k] - a:rl[k]]
            sreads[b, a:n] = u2r[k, ulen2[k] - (n - a):ulen2[k]][::-1]
    screen = (refs, rl, u2r, ulen2, idx, sreads, ql, screen_min_scores(ql))
    return (refs, rl, reads, ql), screen


def verify_case(seed=7, n_ref=5003, L=53, B=64, C=4096):
    """Packed-verify inputs (codes, starts, reads, read_idx, read_lens):
    codes 0..4 with N (4) runs on both sides of candidates, every lane,
    candidates in the plane's last words (their windows run past the
    reference, as out-of-bounds ones do before the caller drops them),
    read lengths 0, 1, 9, 10, 11 and L, an all-N read, repeated reads."""
    rng = np.random.default_rng(seed)
    codes = rng.integers(0, 5, n_ref).astype(np.int8)
    codes[100:140] = 4
    reads = rng.integers(0, 5, (B, L)).astype(np.int8)
    lens = rng.integers(0, L + 1, B).astype(np.int32)
    lens[:6] = (0, 1, 9, 10, 11, L)
    reads[6, :] = 4
    starts = rng.integers(0, n_ref, C).astype(np.int64)
    starts[:10] = np.arange(10)                    # every lane
    starts[10:20] = n_ref - 1 - np.arange(10)      # the last word(s)
    starts[20:30] = 100 + np.arange(10)            # N on both sides
    ridx = rng.integers(0, B, C).astype(np.int32)
    ridx[:64] = np.arange(64) % 8                  # repeats
    ridx[20:30] = 6
    return codes, starts, reads, ridx, lens


def verify_genome_case(device, seed=0, n_bases=3_100_000_000,
                       n_reads=1 << 20, read_len=100, per_read=8):
    """Packed-verify operands at the size a genome index holds, made on
    ``device`` from a seeded ``torch.Generator`` (a host array of 3.1e9
    codes and its packing would take longer than everything that uses it).

    The plane is ``n_bases`` random A/C/G/T (a multiple of 10), packed as
    ``ops.verify_batch.pack_codes3`` packs.  Each read is cut out of it at a
    random start and given 0 to 3 mismatches, the j-th in the read's j-th
    third.  Each read has ``per_read`` candidates: its source window and
    random starts, sorted by (read, position) as
    ``SeedIndex.candidates`` hands them over.

    Returns ``(operands, is_source, planted)``: the operands of
    ``ops.verify_cuda.verify_packed3`` (plane, word10, lane10, packed reads,
    read_idx, read_lens), a (C,) bool mask of the source windows, and the
    (n_reads,) mismatches planted in each read, which is the count its
    source window must get.
    """
    from ..ops.verify_batch import BASES_PER_WORD as per_word
    from ..ops.verify_batch import packed_words
    if n_bases % per_word or read_len < 3:
        raise ValueError("n_bases must be a multiple of 10, read_len >= 3")
    dev = torch.device(device)
    gen = torch.Generator(device=dev)
    gen.manual_seed(seed)

    def draw(high, shape, dtype=torch.int64):
        return torch.randint(0, high, shape, dtype=dtype, device=dev,
                             generator=gen)

    # two random bits a base, spread to the plane's 3-bit slots
    bits = draw(1 << (2 * per_word), (n_bases // per_word,), torch.int32)
    ref3 = torch.zeros_like(bits)
    for j in range(per_word):
        ref3 |= ((bits >> (2 * j)) & 3) << (3 * j)
    del bits

    src = draw(n_bases - read_len + 1, (n_reads,))
    pos = src[:, None] + torch.arange(read_len, device=dev)[None, :]
    codes = (ref3[pos // per_word] >> (3 * (pos % per_word)).to(torch.int32)) \
        & 7
    del pos
    planted = draw(4, (n_reads,))
    third = read_len // 3
    rows = torch.arange(n_reads, device=dev)
    for j in range(3):
        at = j * third + draw(third, (n_reads,))
        other = (codes[rows, at] + 1 + draw(3, (n_reads,), torch.int32)) % 4
        codes[rows, at] = torch.where(planted > j, other, codes[rows, at])
    w = packed_words(read_len)
    padded = torch.zeros((n_reads, w * per_word), dtype=torch.int32,
                         device=dev)
    padded[:, :read_len] = codes
    slots = 3 * torch.arange(per_word, dtype=torch.int32, device=dev)
    reads3 = (padded.view(n_reads, w, per_word) << slots).sum(
        dim=2, dtype=torch.int32)

    starts = torch.cat([src[:, None],
                        draw(n_bases - read_len + 1, (n_reads, per_read - 1))],
                       dim=1).sort(dim=1).values
    is_source = (starts == src[:, None]).reshape(-1)
    starts = starts.reshape(-1)
    ops = (ref3, (starts // per_word).to(torch.int32),
           (starts % per_word).to(torch.uint8), reads3,
           rows.to(torch.int32).repeat_interleave(per_read),
           torch.full((n_reads,), read_len, dtype=torch.int32, device=dev))
    return ops, is_source, planted


def frontend_config(ds, tmp, **overrides):
    """A ``Config`` naming the references of the synthetic dataset ``ds``,
    written under ``tmp``: its genome, its gene models and its transcripts
    (each with a 50 A tail, as the frontend tests build them).  The pair
    SAM is written on every route, so runs can compare it."""
    tmp.mkdir(parents=True, exist_ok=True)
    write_gtf(ds, tmp / "genes.gtf")
    write_genome_fasta(ds, tmp / "genome.fa")
    write_fasta(str(tmp / "cdna.fa"),
                {f"{g.name}|{g.transcript}": g.cdna(ds.genome) + "A" * 50
                 for g in ds.genes})
    values = dict(gene_models=tmp / "genes.gtf",
                  genome_fasta=tmp / "genome.fa", cdna_fasta=tmp / "cdna.fa",
                  pair_sam_checkpoint="eager")
    return Config.defaults(**(values | overrides))


def screen_case():
    """The candidate set of test_split_dp_pallas's screen test."""
    rng = random.Random(3)
    uref1, uref2 = [], []
    for _ in range(5):
        uref1.append(rand_seq(rng, rng.randint(40, 90)))
        uref2.append(rand_seq(rng, rng.randint(40, 90)))
    reads, idx = [], []
    for i in range(40):
        k = rng.randrange(5)
        idx.append(k)
        if i % 3 == 0:
            half = rng.randrange(8, 16)
            r = uref1[k][-half:] + uref2[k][:24 - half]
        else:
            r = rand_seq(rng, 24)
        reads.append(r)
    u1p, u1l = pad_batch(uref1, 128)
    u2p, u2l = pad_batch([s[::-1] for s in uref2], 128)
    rp, rl = pad_batch(reads, 24)
    mins = np.array([accept_threshold(len(r)) for r in reads],
                    dtype=np.int32)
    return u1p, u1l, u2p, u2l, np.array(idx, np.int32), rp, rl, mins
