"""Seeded synthetic genome and tumour RNA-seq libraries, in NumPy.

The genome and its genes come from the configuration alone (its
``genome_seed``), so a reference dataset is built once per configuration.
A library comes from the configuration, a traffic mix and ``--seed``:

* ``n_fusions`` gene pairs (two genes on different chromosomes, no gene in
  two pairs) joined at a random breakpoint, each with ``frags_per_fusion``
  fragments across the junction;
* one-ended chimeric decoys at the fusion loci: one end a real read of a
  fusion gene beside its breakpoint, pointing at it, the mate random bases;
* the rest concordant background over all genes, uniform expression.

Pairs are shuffled, and each keeps its truth (kind, gene or fusion, start
and length in transcript coordinates), which is what ``reference.py``
reads.  This is the bench generator of ``defuse_tpu_torch/utils/synth.py``
(gene structure, fusion and decoy model) made vectorised, seeded and free
of the fixed 50 bp read.
"""

from __future__ import annotations

import dataclasses
import json
import pathlib

import numpy as np

ACGT = np.frombuffer(b"ACGT", dtype=np.uint8)
COMP = np.zeros(256, dtype=np.uint8)
COMP[list(b"ACGTN")] = list(b"TGCAN")

KIND_BACKGROUND, KIND_FUSION, KIND_DECOY = 0, 1, 2


def revcomp(codes: np.ndarray) -> np.ndarray:
    """Reverse complement of ASCII bases along the last axis."""
    return COMP[codes[..., ::-1]]


@dataclasses.dataclass
class Genes:
    """The genes of a genome: exons in genomic coordinates (1-based,
    inclusive), strand (0 +, 1 -), and the spliced cDNA in transcript
    orientation, concatenated (``cdna[offsets[g]:offsets[g + 1]]``); and the
    chromosomes themselves, concatenated (chromosome ``c`` from
    ``genome[chrom_offsets[c - 1]]``)."""
    chrom: np.ndarray       # (G,) int, 1-based chromosome number
    strand: np.ndarray      # (G,) int
    exons: np.ndarray       # (G, E, 2) int64
    cdna: np.ndarray        # uint8
    offsets: np.ndarray     # (G + 1,) int64
    genome: np.ndarray      # uint8
    chrom_offsets: np.ndarray  # (C + 1,) int64

    @property
    def lengths(self) -> np.ndarray:
        return np.diff(self.offsets)

    def name(self, g: int) -> str:
        return f"G{g}"

    def seq(self, g: int) -> np.ndarray:
        return self.cdna[self.offsets[g]:self.offsets[g + 1]]

    def save(self, path: pathlib.Path) -> None:
        np.savez(path, **dataclasses.asdict(self))

    @classmethod
    def load(cls, path: pathlib.Path) -> "Genes":
        with np.load(path) as z:
            return cls(**{k: z[k] for k in z.files})


def make_genome(cfg: dict) -> tuple[list[np.ndarray], Genes]:
    """The configuration's chromosomes (uint8 ASCII) and genes."""
    g = cfg["genome"]
    rng = np.random.default_rng(g["genome_seed"])
    chroms = [ACGT[rng.integers(0, 4, g["chromosome_length"], np.uint8)]
              for _ in range(g["chromosomes"])]
    lo_gap, hi_gap = g["intergenic"]
    lo_exon, hi_exon = g["exon_length"]
    lo_intron, hi_intron = g["intron_length"]
    chrom_of, strand_of, exons = [], [], []
    for c in range(g["chromosomes"]):
        pos = int(g["first_gene_at"])
        while True:
            lens = rng.integers(lo_exon, hi_exon + 1, g["exons_per_gene"])
            introns = rng.integers(lo_intron, hi_intron + 1,
                                   g["exons_per_gene"] - 1)
            starts = pos + np.concatenate([[0], np.cumsum(lens[:-1] +
                                                          introns)])
            ends = starts + lens - 1
            if ends[-1] + 1000 >= g["chromosome_length"]:
                break
            chrom_of.append(c + 1)
            strand_of.append(int(rng.integers(0, 2)))
            exons.append(np.stack([starts, ends], axis=1))
            pos = int(ends[-1]) + int(rng.integers(lo_gap, hi_gap + 1))
    exons = np.asarray(exons, dtype=np.int64)
    pieces = []
    for c, s, ex in zip(chrom_of, strand_of, exons):
        seq = np.concatenate([chroms[c - 1][a - 1:b] for a, b in ex])
        pieces.append(revcomp(seq) if s else seq)
    offsets = np.concatenate([[0], np.cumsum([len(p) for p in pieces])])
    chrom_offsets = np.concatenate([[0], np.cumsum([len(c) for c in chroms])])
    genes = Genes(np.asarray(chrom_of), np.asarray(strand_of), exons,
                  np.concatenate(pieces), offsets.astype(np.int64),
                  np.concatenate(chroms), chrom_offsets.astype(np.int64))
    return chroms, genes


def write_reference_inputs(cfg: dict, out: pathlib.Path) -> pathlib.Path:
    """Genome FASTA, GTF, repeats and the ``run`` config (deFuse's defaults:
    only the paths are set) under ``out``; the genes as ``genes.npz``.
    Returns the config's path."""
    out.mkdir(parents=True, exist_ok=True)
    chroms, genes = make_genome(cfg)
    with open(out / "genome.fa", "wb") as fh:
        for c, seq in enumerate(chroms):
            fh.write(f">{c + 1}\n".encode())
            n = len(seq) // 60 * 60
            lines = np.concatenate(
                [seq[:n].reshape(-1, 60),
                 np.full((n // 60, 1), ord("\n"), np.uint8)], axis=1)
            fh.write(lines.tobytes())
            if n < len(seq):
                fh.write(seq[n:].tobytes() + b"\n")
    with open(out / "genes.gtf", "w") as fh:
        for g in range(len(genes.chrom)):
            strand = "-" if genes.strand[g] else "+"
            attrs = (f'gene_id "{genes.name(g)}"; transcript_id "T{g}"; '
                     f'gene_name "{genes.name(g)}_name"; '
                     f'gene_biotype "protein_coding";')
            n_ex = len(genes.exons[g])
            for i, (s, e) in enumerate(genes.exons[g]):
                row = f"{genes.chrom[g]}\tprotein_coding\t{{}}\t{s}\t{e}\t." \
                      f"\t{strand}\t.\t{attrs}\n"
                fh.write(row.format("exon"))
                if 0 < i < n_ex - 1:
                    fh.write(row.format("CDS"))
    rng = np.random.default_rng(cfg["genome"]["genome_seed"] + 1)
    with open(out / "repeats.regions", "w") as fh:
        for _ in range(cfg["genome"]["repeats"]):
            c = int(rng.integers(1, len(chroms) + 1))
            start = int(rng.integers(0, len(chroms[c - 1]) - 2000))
            end = start + int(rng.integers(100, 1900))
            fh.write(f"{c}\t{start}\t{end}\tSynthRep\n")
    genes.save(out / "genes.npz")
    return write_run_config(out)


def write_run_config(out: pathlib.Path) -> pathlib.Path:
    """The ``run`` config naming the inputs under ``out`` (deFuse's
    defaults for every other key); written anew by every run, since the
    checkout may have moved since the inputs were made."""
    paths = {
        "genome_fasta": out / "genome.fa",
        "gene_models": out / "genes.gtf",
        "repeats_regions": out / "repeats.regions",
        "dataset_prefix": "$(dataset_directory)/defuse",
        "cdna_regions": "$(dataset_prefix).cdna.regions",
        "cdna_fasta": "$(dataset_prefix).cdna.fa",
        "exons_fasta": "$(dataset_prefix).exons.fa",
        "cds_fasta": "$(dataset_prefix).cds.fa",
        "reference_fasta": "$(dataset_prefix).reference.fa",
        "rrna_fasta": "$(dataset_prefix).rrna.fa",
        "ig_gene_list": "$(dataset_prefix).ig.gene.list",
    }
    config = out / "config.txt"
    config.write_text("".join(f"{k} = {v}\n" for k, v in paths.items()))
    return config


@dataclasses.dataclass
class Fusions:
    """Planted fusions: 5' gene ``a`` up to ``break_a`` (1-based, last base
    of a's cDNA kept), then 3' gene ``b`` from ``break_b`` on."""
    a: np.ndarray
    b: np.ndarray
    break_a: np.ndarray
    break_b: np.ndarray

    def seq(self, genes: Genes, f: int) -> np.ndarray:
        return np.concatenate([genes.seq(self.a[f])[:self.break_a[f]],
                               genes.seq(self.b[f])[self.break_b[f] - 1:]])


@dataclasses.dataclass
class Library:
    """A library's truth, pair by pair in file order.  ``start`` and
    ``flen`` place the fragment (1-based) in the cDNA of ``gene``
    (background), in the fusion's sequence (fusion), or give the anchored
    read's start in ``gene``'s cDNA and the decoy's side (0: 5' gene, read
    forward; 1: 3' gene, read reversed) (decoy)."""
    read_len: int
    kind: np.ndarray
    fusion: np.ndarray      # fusion index, -1 for background
    gene: np.ndarray        # gene of a background pair or a decoy's anchor
    start: np.ndarray
    flen: np.ndarray
    side: np.ndarray
    fusions: Fusions

    @property
    def n_pairs(self) -> int:
        return len(self.kind)


def draw_fusions(genes: Genes, n: int, rng) -> Fusions:
    """``n`` gene pairs on different chromosomes, no gene in two pairs, and
    a breakpoint in each that leaves room for fragments on both sides."""
    order = rng.permutation(len(genes.chrom))
    a, b, used = [], [], set()
    for g in order:
        if len(a) == n:
            break
        if g in used:
            continue
        for h in order:
            if h not in used and h != g and genes.chrom[h] != genes.chrom[g]:
                a.append(g)
                b.append(h)
                used.update((g, h))
                break
    if len(a) < n:
        raise ValueError(f"genome holds fewer than {n} disjoint gene pairs")
    a, b = np.asarray(a), np.asarray(b)
    lens = genes.lengths
    break_a = rng.integers(800, lens[a] - 400 + 1)
    break_b = rng.integers(400, lens[b] - 800 + 1)
    return Fusions(a, b, break_a, break_b)


def _frag_lengths(rng, n, mean, sd, lo, hi):
    f = np.rint(rng.normal(mean, sd, n)).astype(np.int64)
    return np.clip(f, lo, hi)


def make_library(cfg: dict, mix: dict, genes: Genes, seed: int,
                 n_pairs: int | None = None) -> Library:
    """A library of ``n_pairs`` (default: the configuration's) from
    ``seed``: the mix's fusions and their fragments as they are, its decoys
    a share of the pairs, the rest background."""
    rng = np.random.default_rng(seed)
    L = cfg["read_length"]
    mean, sd = cfg["fragment"]["mean"], cfg["fragment"]["sd"]
    n_pairs = n_pairs or cfg["library_pairs"]
    n_fus, frags = mix["fusions"], mix["frags_per_fusion"]
    n_decoy = int(round(mix["decoy_share"] * n_pairs))
    fus = draw_fusions(genes, n_fus, rng)
    lens = genes.lengths

    # fragments across each junction: start uniform so that the fragment
    # covers the junction (as the bench generator draws them)
    f_idx = np.repeat(np.arange(n_fus), frags)
    f_len = _frag_lengths(rng, len(f_idx), mean, sd, 2 * L, 10 ** 6)
    fus_len = fus.break_a[f_idx] + lens[fus.b[f_idx]] - fus.break_b[f_idx] + 1
    lo = np.maximum(1, fus.break_a[f_idx] - f_len + 10)
    hi = np.minimum(fus.break_a[f_idx] + 40, fus_len - f_len + 1)
    f_start = lo + (rng.random(len(f_idx)) * (hi - lo + 1)).astype(np.int64)

    # one-ended decoys: the anchored read lies within one fragment of the
    # junction, on the side a mate across the junction would have it
    d_fus = np.arange(n_decoy) % n_fus
    d_side = rng.integers(0, 2, n_decoy)
    d_gene = np.where(d_side == 0, fus.a[d_fus], fus.b[d_fus])
    d_len = _frag_lengths(rng, n_decoy, mean, sd, 2 * L, 10 ** 6)
    off = (rng.random(n_decoy) * (d_len - L + 1)).astype(np.int64)
    d_start = np.where(d_side == 0, fus.break_a[d_fus] - d_len + 1 + off,
                       fus.break_b[d_fus] + off)
    d_start = np.clip(d_start, 1, lens[d_gene] - L + 1)

    n_bg = n_pairs - len(f_idx) - n_decoy
    if n_bg < 0:
        raise ValueError("the mix has more fusion and decoy pairs than the "
                         "library holds")
    b_gene = rng.integers(0, len(lens), n_bg)
    b_len = _frag_lengths(rng, n_bg, mean, sd, 2 * L, lens[b_gene] - 1)
    b_start = 1 + (rng.random(n_bg) * (lens[b_gene] - b_len + 1)).astype(
        np.int64)

    kind = np.concatenate([np.full(len(f_idx), KIND_FUSION),
                           np.full(n_decoy, KIND_DECOY),
                           np.full(n_bg, KIND_BACKGROUND)]).astype(np.int8)
    cols = dict(
        fusion=np.concatenate([f_idx, d_fus, np.full(n_bg, -1)]),
        gene=np.concatenate([np.full(len(f_idx), -1), d_gene, b_gene]),
        start=np.concatenate([f_start, d_start, b_start]),
        flen=np.concatenate([f_len, d_len, b_len]),
        side=np.concatenate([np.zeros(len(f_idx), np.int64), d_side,
                             np.zeros(n_bg, np.int64)]))
    perm = rng.permutation(n_pairs)
    return Library(L, kind[perm], fusions=fus,
                   **{k: v[perm].astype(np.int64) for k, v in cols.items()})


def library_reads(lib: Library, genes: Genes, seed: int):
    """The (N, L) uint8 reads of both ends: read 1 forward from the
    fragment's start, read 2 the reverse complement of its end."""
    L, N = lib.read_len, lib.n_pairs
    r1 = np.empty((N, L), np.uint8)
    r2 = np.empty((N, L), np.uint8)
    cols = np.arange(L)
    bg = lib.kind == KIND_BACKGROUND
    base = genes.offsets[lib.gene[bg]] + lib.start[bg] - 1
    r1[bg] = genes.cdna[base[:, None] + cols]
    r2[bg] = revcomp(genes.cdna[(base + lib.flen[bg] - L)[:, None] + cols])
    # fusion fragments from their fusion's sequence
    fus = lib.fusions
    seqs = [fus.seq(genes, f) for f in range(len(fus.a))]
    f_off = np.concatenate([[0], np.cumsum([len(s) for s in seqs])])
    allseq = np.concatenate(seqs)
    fm = lib.kind == KIND_FUSION
    base = f_off[lib.fusion[fm]] + lib.start[fm] - 1
    r1[fm] = allseq[base[:, None] + cols]
    r2[fm] = revcomp(allseq[(base + lib.flen[fm] - L)[:, None] + cols])
    # decoys: the anchored read (forward on a 5' gene, reversed on a 3'
    # gene) as end 1, random bases as end 2
    dm = lib.kind == KIND_DECOY
    base = genes.offsets[lib.gene[dm]] + lib.start[dm] - 1
    anchor = genes.cdna[base[:, None] + cols]
    r1[dm] = np.where((lib.side[dm] == 0)[:, None], anchor, revcomp(anchor))
    junk = np.random.default_rng([seed, 7]).integers(0, 4, (dm.sum(), L),
                                                     np.uint8)
    r2[dm] = ACGT[junk]
    return r1, r2


def write_fastq(path: pathlib.Path, reads: np.ndarray, end: int) -> int:
    """Write reads as FASTQ records ``@<9-digit index>/<end>``, quality
    ``I``; returns the bytes written."""
    N, L = reads.shape
    head = np.frombuffer(b"@000000000/%d\n" % end, np.uint8)
    rec = len(head) + L + 3 + L + 1
    buf = np.empty((N, rec), np.uint8)
    buf[:, :len(head)] = head
    digits = np.arange(N)
    for k in range(9):
        buf[:, 9 - k] = ord("0") + digits % 10
        digits //= 10
    p = len(head)
    buf[:, p:p + L] = reads
    buf[:, p + L:p + L + 3] = np.frombuffer(b"\n+\n", np.uint8)
    buf[:, p + L + 3:p + 2 * L + 3] = ord("I")
    buf[:, -1] = ord("\n")
    with open(path, "wb") as fh:
        fh.write(buf.tobytes())
    return buf.size


def write_library(lib: Library, genes: Genes, seed: int,
                  out: pathlib.Path) -> tuple[pathlib.Path, pathlib.Path, int]:
    """The library's two FASTQ files under ``out``; returns their paths and
    the bytes written."""
    out.mkdir(parents=True, exist_ok=True)
    r1, r2 = library_reads(lib, genes, seed)
    fq1, fq2 = out / "reads.1.fastq", out / "reads.2.fastq"
    n = write_fastq(fq1, r1, 1) + write_fastq(fq2, r2, 2)
    return fq1, fq2, n


def load_json(path) -> dict:
    return json.loads(pathlib.Path(path).read_text())
