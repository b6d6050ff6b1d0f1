"""Cluster post-filter cascade (``defuse_run.pl:455-549``):

* ``merge_clusters``          — renumber shard outputs contiguously
* ``segregate_mitochondrial`` — drop MT-vs-genome clusters
* ``select_fusion_clusters``  — drop same-gene and both-sides-intergenic
* ``prep_local_alignment_seqs`` + localalign screen — kill clusters whose
  paired reads align concordantly to one locus
* ``remove_duplicates``       — dedupe fragments with identical 5'
  position pairs, re-apply the min cluster size

Line filters preserve input row order (byte-comparable to the reference
Perl); hash-ordered reference scripts (prep seqs, dedupe survivor choice)
use canonical ascending order here.
"""

from __future__ import annotations

from ..align.sw import localalign_stream
from ..annotate.gene_models import GeneModels


def _cluster_groups(lines):
    group: list[str] = []
    current = None
    for line in lines:
        cid = int(line.split("\t", 1)[0])
        if current is not None and cid != current:
            yield current, group
            group = []
        current = cid
        group.append(line)
    if group:
        yield current, group


def _parse(line):
    f = line.rstrip("\n").split("\t")
    return (int(f[0]), int(f[1]), int(f[2]), int(f[3]), f[4], f[5],
            int(f[6]), int(f[7]))


def merge_clusters(files_lines):
    """Renumber clusters contiguously across shard outputs
    (``merge_clusters.pl``)."""
    out = []
    cid = 0
    for lines in files_lines:
        prev = None
        for line in lines:
            f = line.rstrip("\n").split("\t")
            if prev is not None and int(f[0]) != prev:
                cid += 1
            prev = int(f[0])
            f[0] = str(cid)
            out.append("\t".join(f) + "\n")
        if prev is not None:
            cid += 1
    return out


def segregate_mitochondrial(lines, gene_models: GeneModels,
                            mt_chromosome: str):
    """Keep clusters unless exactly one side is mitochondrial
    (``segregate_mitochondrial.pl``)."""
    out = []
    for _cid, group in _cluster_groups(lines):
        chroms = {}
        for line in group:
            (_c, cend, _f, _re, ref, _s, _st, _en) = _parse(line)
            chroms[cend] = gene_models.calc_genomic_chromosome(ref)
        if (chroms[0] != mt_chromosome and chroms[1] != mt_chromosome) \
                or chroms[0] == chroms[1]:
            out.extend(group)
    return out


def select_fusion_clusters(lines, gene_models: GeneModels):
    """Drop same-gene and both-sides-intergenic clusters
    (``select_fusion_clusters.pl``)."""
    out = []
    for _cid, group in _cluster_groups(lines):
        ends: dict[int, dict] = {}
        for line in group:
            (_c, cend, _f, _re, ref, _s, start, end) = _parse(line)
            d = ends.setdefault(cend, {"ref": ref, "start": start,
                                       "end": end})
            d["start"] = min(d["start"], start)
            d["end"] = max(d["end"], end)
        genes = {}
        locs = {}
        for cend, d in ends.items():
            pos = (d["start"] + d["end"]) / 2
            gene = gene_models.calc_gene(d["ref"], pos)
            gpos = gene_models.calc_genomic_position(d["ref"], pos)
            genes[cend] = gene
            locs[cend] = gene_models.calc_gene_location(gene, gpos)
        if genes[0] == genes[1]:
            continue
        inter = [locs[e] in ("upstream", "downstream") for e in (0, 1)]
        if inter[0] and inter[1]:
            continue
        out.extend(group)
    return out


def prep_local_alignment_seqs(lines, gene_models: GeneModels, reference,
                              seq_range: int):
    """Candidate (id, reference window, paired sequence) rows for the
    localalign concordance screen (``prep_local_alignment_seqs.pl``)."""
    clusters: dict[int, dict[int, dict]] = {}
    for line in lines:
        (cid, cend, _f, _re, ref, strand, start, end) = _parse(line)
        d = clusters.setdefault(cid, {}).setdefault(
            cend, {"ref": ref, "strand": strand, "start": start,
                   "end": end})
        d["start"] = min(d["start"], start)
        d["end"] = max(d["end"], end)

    rows = []

    def emit(cid, ref_name, midpoint, strand, other_seq, other_strand):
        if strand == "+":
            start, end = midpoint, midpoint + seq_range
        else:
            start, end = midpoint - seq_range, midpoint
        if ref_name not in reference:
            return
        seq, _, _ = reference.get(ref_name, 0, int(start),
                                  int(end) - int(start) + 1)
        if not seq:
            return
        if strand == other_strand:
            from ..core.types import revcomp
            seq = revcomp(seq)
        rows.append(f"{cid}\t{seq}\t{other_seq}")

    for cid in sorted(clusters):
        for cend in (0, 1):
            other = clusters[cid][1 - cend]
            oseq, _, _ = reference.get(
                other["ref"], 0, other["start"],
                other["end"] - other["start"] + 1)
            d = clusters[cid][cend]
            midpoint = (d["start"] + d["end"]) / 2
            chromosome = gene_models.calc_genomic_chromosome(d["ref"])
            g_mid = gene_models.calc_genomic_position(d["ref"],
                                                      int(midpoint))
            g_strand = gene_models.calc_genomic_strand(d["ref"],
                                                      d["strand"])
            emit(cid, chromosome, g_mid, g_strand, oseq, other["strand"])
            for gene_id in gene_models.calc_overlapping_genes(
                    d["ref"], (d["start"], d["end"])):
                loc = gene_models.calc_gene_location(gene_id, g_mid)
                if loc not in ("coding", "utr5p", "utr3p"):
                    continue
                for tid in sorted(
                        gene_models.genes[gene_id].transcripts):
                    t_mid = gene_models.calc_transcript_position(tid,
                                                                 g_mid)
                    t_strand = gene_models.calc_transcript_strand(
                        tid, g_strand)
                    emit(cid, tid, t_mid, t_strand, oseq,
                         other["strand"])
    return rows


def local_align_screen(lines, gene_models: GeneModels, reference,
                       seq_range: int):
    """Cluster ids failing the local concordance screen (match 10,
    mismatch -5, gap -5, threshold 0.8; ``defuse_run.pl:489-505``)."""
    seq_rows = prep_local_alignment_seqs(lines, gene_models, reference,
                                         seq_range)
    from ..cluster import native
    if native.available():
        # batch scorer (integer-exact SimpleAligner twin, threaded);
        # identical failed set to the localalign_stream oracle —
        # pinned by tests/test_stats_filters.py
        parts = [row.split("\t") for row in seq_rows]
        scores = native.localalign_batch([p[1] for p in parts],
                                         [p[2] for p in parts],
                                         10, -5, -5)
        if scores is not None:
            return {int(p[0]) for p, s in zip(parts, scores)
                    if len(p[2]) and s / (len(p[2]) * 10) >= 0.8}
    failed = set()
    for row in localalign_stream(seq_rows, 10, -5, -5, 0.8):
        failed.add(int(row.split("\t", 1)[0]))
    return failed


def filter_clusters_by_id(lines, drop_ids):
    """``filter_column.pl <ids> 0 1`` equivalent (invert: keep misses)."""
    return [l for l in lines if int(l.split("\t", 1)[0]) not in drop_ids]


def remove_duplicates(lines, min_cluster_size: int):
    """Dedupe fragments with identical 5' position pairs; drop clusters
    below the minimum size (``remove_duplicates.pl``; survivor choice by
    ascending fragment id — canonical)."""
    out = []
    for _cid, group in _cluster_groups(lines):
        positions: dict[int, dict[int, int]] = {}
        rows: dict[int, dict[int, str]] = {}
        for line in group:
            (cid, cend, frag, _re, _ref, strand, start, end) = _parse(line)
            pos = start if strand == "+" else end
            positions.setdefault(frag, {})[cend] = pos
            rows.setdefault(frag, {})[cend] = line
        undup = []
        seen_pairs = set()
        for frag in sorted(positions):
            pair = (positions[frag].get(0), positions[frag].get(1))
            if pair in seen_pairs:
                continue
            seen_pairs.add(pair)
            undup.append(rows[frag][0])
            undup.append(rows[frag][1])
        if len(undup) >= 2 * min_cluster_size:
            out.extend(undup)
    return out


def apply_post_setcover_filters(lines, gene_models: GeneModels, reference,
                                *, seq_range: int, min_cluster_size: int):
    """select_fusion_clusters -> localalign screen -> dedupe
    (``defuse_run.pl:482-505``); mito segregation runs before setcover
    (``defuse_run.pl:466-468``)."""
    lines = select_fusion_clusters(lines, gene_models)
    failed = local_align_screen(lines, gene_models, reference, seq_range)
    lines = filter_clusters_by_id(lines, failed)
    return remove_duplicates(lines, min_cluster_size)
