"""Reference dataset creation — the ``defuse_create_ref.pl`` equivalent.

From local inputs (genome fasta + GTF gene models; this build performs no
downloads — provide the Ensembl/UCSC files via config paths), derives the
dataset files the pipeline consumes (``defuse_create_ref.pl:274-629``):

* gene/transcript tables filtered by chromosome and gene_biotype
* ``cdna.fa`` — spliced transcripts + 50-base polyA tails
* ``cdna.regions`` — exon-regions file (trailing-tab rows, reference fmt)
* ``exons.fa`` — per-exon unspliced sequences named gene|transcript|n
* ``cds.fa`` — spliced CDS sequences
* ``rrna.fa`` — spliced rRNA-biotype transcripts
* ``ig.gene.list`` — IG-biotype gene ids
* ``reference.fa`` (+ .fai) — genome + cdna concatenated
* seed indices for the aligner frontend (.seedidx arrays, mmap-loaded
  at run — the bowtie-build equivalent)
"""

from __future__ import annotations

import pathlib
import re

from ..core.types import revcomp
from ..io.fasta import FastaStore, write_fasta

_ATTR_RE = re.compile(r"(\S+)\s+(.*)")

DEFAULT_GENE_BIOTYPES = {"IG_C_gene", "IG_D_gene", "IG_J_gene",
                         "IG_V_gene", "processed_transcript",
                         "protein_coding"}
DEFAULT_IG_BIOTYPES = {"IG_C_gene", "IG_D_gene", "IG_J_gene", "IG_V_gene",
                       "IG_pseudogene"}
DEFAULT_RRNA_BIOTYPES = {"Mt_rRNA", "rRNA", "rRNA_pseudogene"}


def create_reference(config, dataset_directory: str) -> dict:
    genome_fasta = config.get_value("genome_fasta")
    gene_models = config.get_value("gene_models")
    chromosomes = set(config.get_list("chromosomes")) \
        if config.has_value("chromosomes") else None
    gene_biotypes = set(config.get_list("gene_biotypes")) \
        if config.has_value("gene_biotypes") else DEFAULT_GENE_BIOTYPES
    ig_biotypes = set(config.get_list("ig_gene_biotypes")) \
        if config.has_value("ig_gene_biotypes") else DEFAULT_IG_BIOTYPES
    rrna_biotypes = set(config.get_list("rrna_gene_biotypes")) \
        if config.has_value("rrna_gene_biotypes") else \
        DEFAULT_RRNA_BIOTYPES

    dataset = pathlib.Path(dataset_directory)
    dataset.mkdir(parents=True, exist_ok=True)
    prefix = dataset / "defuse"

    # --- parse gene models ---------------------------------------------
    accepted = {"CDS", "exon", "start_codon", "stop_codon"}
    transcripts: dict[str, dict] = {}
    candidate: set[str] = set()
    rrna: set[str] = set()
    ig_genes: set[str] = set()
    with open(gene_models) as fh:
        for line in fh:
            if line.startswith("#"):
                continue
            f = line.rstrip("\n").split("\t")
            if f[2] not in accepted:
                continue
            attrs = {}
            for part in f[8].split(";"):
                m = _ATTR_RE.match(part.strip())
                if m:
                    attrs[m.group(1)] = m.group(2).replace('"', "")
            biotype = attrs.get("gene_biotype", f[1])
            gene_id = attrs["gene_id"]
            tid = gene_id + "|" + attrs["transcript_id"]
            if biotype in ig_biotypes:
                ig_genes.add(gene_id)
            if biotype not in gene_biotypes and biotype not in \
                    rrna_biotypes:
                continue
            if chromosomes is not None and f[0] not in chromosomes:
                continue
            if biotype in gene_biotypes:
                candidate.add(tid)
            if biotype in rrna_biotypes:
                rrna.add(tid)
            t = transcripts.setdefault(tid, {
                "gene": gene_id, "chromosome": f[0], "strand": f[6],
                "exons": [], "cds": []})
            if f[2] == "exon":
                t["exons"].append((int(f[3]), int(f[4])))
            elif f[2] == "CDS":
                t["cds"].append((int(f[3]), int(f[4])))
    for t in transcripts.values():
        t["exons"].sort()
        t["cds"].sort()

    genome = FastaStore.from_file(genome_fasta)

    def spliced(t, regions_key):
        t_info = transcripts[t]
        chrom = genome.sequence(t_info["chromosome"])
        seq = "".join(chrom[s - 1:e] for s, e in t_info[regions_key])
        if t_info["strand"] == "-":
            seq = revcomp(seq)
        return seq

    # --- derive fastas --------------------------------------------------
    cdna_path = str(prefix) + ".cdna.fa"
    cdna_seqs = {}
    regions_lines = []
    for tid in sorted(candidate):
        if not transcripts[tid]["exons"]:
            continue
        cdna_seqs[tid] = spliced(tid, "exons") + "A" * 50
        t = transcripts[tid]
        fields = [t["gene"], tid.split("|", 1)[1], t["chromosome"],
                  t["strand"]]
        for s, e in t["exons"]:
            fields += [str(s), str(e)]
        regions_lines.append("\t".join(fields) + "\t")
    write_fasta(cdna_path, cdna_seqs)
    regions_path = str(prefix) + ".cdna.regions"
    with open(regions_path, "w") as out:
        out.write("\n".join(regions_lines) + "\n" if regions_lines else "")

    exons_path = str(prefix) + ".exons.fa"
    exon_seqs = {}
    for tid in sorted(candidate):
        t = transcripts[tid]
        chrom = genome.sequence(t["chromosome"])
        for n, (s, e) in enumerate(t["exons"]):
            seq = chrom[s - 1:e]
            if t["strand"] == "-":
                seq = revcomp(seq)
            exon_seqs[f"{tid}|{n}"] = seq
    write_fasta(exons_path, exon_seqs)

    cds_path = str(prefix) + ".cds.fa"
    cds_seqs = {tid: spliced(tid, "cds") for tid in sorted(candidate)
                if transcripts[tid]["cds"]}
    write_fasta(cds_path, cds_seqs)

    rrna_path = str(prefix) + ".rrna.fa"
    write_fasta(rrna_path, {tid: spliced(tid, "exons")
                            for tid in sorted(rrna)
                            if transcripts[tid]["exons"]})

    ig_path = str(prefix) + ".ig.gene.list"
    with open(ig_path, "w") as out:
        for g in sorted(ig_genes):
            out.write(g + "\n")

    reference_path = str(prefix) + ".reference.fa"
    ref_seqs = dict(genome._seqs)
    ref_seqs.update(cdna_seqs)
    write_fasta(reference_path, ref_seqs)

    # --- seed indices (bowtie-build equivalent: build once here,
    # mmap-load at run) -------------------------------------------------
    from ..align.seedindex import SeedIndex

    def build_index(seqs, out_prefix):
        total_bp = sum(len(s) for s in seqs.values())
        if total_bp > 512_000_000:
            # genome-scale: bounded-memory per-chunk build + K-way merge
            # (byte-identical output files, mmap-loaded afterwards)
            SeedIndex.build_to_disk(seqs, out_prefix)
        else:
            SeedIndex(seqs).save(out_prefix)

    for fasta in (cdna_path, rrna_path):
        build_index(FastaStore.from_file(fasta)._seqs,
                    fasta + ".seedidx")
    # the genome fasta lives outside the dataset dir; cache its index
    # under the dataset prefix
    build_index(FastaStore.from_file(genome_fasta)._seqs,
                str(prefix) + ".genome.seedidx")

    return {
        "cdna_fasta": cdna_path, "cdna_regions": regions_path,
        "exons_fasta": exons_path, "cds_fasta": cds_path,
        "rrna_fasta": rrna_path, "ig_gene_list": ig_path,
        "reference_fasta": reference_path,
    }
