"""What a ``run`` wrote, read from its output directory: the frontend's
split of the pairs, discover's split-read breakpoints and the results
table.  Reads files only; imports nothing of the program."""

from __future__ import annotations

import csv
import dataclasses
import pathlib

import numpy as np

from generator import Genes
from reference import (CONCORDANT, IMPROPER, SPANNING, genome_to_transcript,
                       transcript_to_genome)

# what ``read_run`` reads of a run's output directory
FILES = ("aligned/improper.sam", "aligned/spanning.compact",
         "concordant.read.stats", "splitreads.break", "results.tsv")


@dataclasses.dataclass
class Observed:
    classes: np.ndarray            # (N,) int8: SPANNING, IMPROPER, or -1
    n_concordant: int
    breaks: list[tuple]            # discover: ((ref, pos), (ref, pos)) a cluster
    results: list[dict]            # results.tsv rows


def out_bytes(path: pathlib.Path) -> int:
    """Bytes of every file under a run's output directory."""
    return sum(f.stat().st_size for f in path.rglob("*") if f.is_file())


def gene_id(name: str) -> int:
    return int(name[1:])


def in_gene(genes: Genes, g: int, ref: str, pos: int) -> list[int]:
    """A position on a chromosome (genomic) or on ``G<g>|T<g>`` (cDNA) as
    the cDNA positions of gene ``g`` it can stand for; none where it is not
    on ``g``'s chromosome or transcript."""
    if "|" in ref:
        return [pos] if gene_id(ref.split("|")[0]) == g else []
    if ref != str(genes.chrom[g]):
        return []
    return genome_to_transcript(genes, g, pos)


def _ids(path: pathlib.Path, strip_end: bool) -> np.ndarray:
    with open(path, "rb") as fh:
        col = [line.split(b"\t", 1)[0] for line in fh]
    if strip_end:
        col = [c.split(b"/", 1)[0] for c in col]
    return np.unique(np.array(col, dtype=np.int64)) if col else \
        np.zeros(0, np.int64)


def read_run(out: pathlib.Path, genes: Genes, n_pairs: int) -> Observed:
    out = pathlib.Path(out)
    classes = np.full(n_pairs, -1, np.int8)
    classes[_ids(out / "aligned" / "improper.sam", True)] = IMPROPER
    classes[_ids(out / "aligned" / "spanning.compact", False)] = SPANNING
    with open(out / "concordant.read.stats") as fh:
        n_conc = int(next(csv.DictReader(fh, delimiter="\t"))["frag_count"])
    sides: dict[str, list] = {}
    with open(out / "splitreads.break") as fh:
        for line in fh:
            cluster, _end, ref, _strand, pos = line.rstrip("\n").split("\t")
            sides.setdefault(cluster, []).append((ref, int(pos)))
    breaks = [tuple(v) for v in sides.values()]
    with open(out / "results.tsv") as fh:
        results = list(csv.DictReader(fh, delimiter="\t"))
    return Observed(classes, n_conc, breaks, results)


def from_expected(exp, genes: Genes) -> Observed:
    """The reference's answer in the form of a run's (the control, put in
    the program's place)."""
    classes = np.where(np.isin(exp.classes, (SPANNING, IMPROPER)),
                       exp.classes, -1).astype(np.int8)
    breaks, results = [], []
    for (ga, gb), allowed, span in zip(exp.gene_ids, exp.breakpoints,
                                       exp.span_counts):
        pa, pb = sorted(allowed)[0]
        breaks.append(((f"G{ga}|T{ga}", pa), (f"G{gb}|T{gb}", pb)))
        results.append({
            "gene1": f"G{ga}", "gene2": f"G{gb}", "span_count": str(span),
            "genomic_break_pos1": str(transcript_to_genome(genes, ga, pa)),
            "genomic_break_pos2": str(transcript_to_genome(genes, gb, pb))})
    return Observed(classes, int((exp.classes == CONCORDANT).sum()), breaks,
                    results)

