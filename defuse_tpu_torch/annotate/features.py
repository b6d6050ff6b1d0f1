"""Fusion annotation feature factory — the ``annotate_fusions.pl``
equivalent.

Computes the ~45 per-fusion features (genes, genomic coordinates, repeat
proportion, splice-variant census, breakpoint-adjacent entropy, span
coverage, PSL-derived percent identities and homology, ORF phase, exon
boundaries, splice-site score, event classification, mapping stats) and
emits (cluster_id, key, value) rows in the reference's exact key order
(``annotate_fusions.pl:866-944``).  Numeric values format with Perl's
%.15g stringification.
"""

from __future__ import annotations

import math

from ..io.fasta import FastaStore
from ..stats.readstats import _perl_num
from .gene_models import GeneModels

ENTROPY_ADJACENT = 40
GENOME_MAX_INS = 2000
EST_MAX_INS = 10000
CDNA_MAX_INS = 10000000


def revcomp(seq: str) -> str:
    from ..core.types import revcomp as _rc
    return _rc(seq)


def calc_entropy(seq: str) -> float:
    """Di-nucleotide entropy (``annotate_fusions.pl:216-238``): overlapping
    pair counts via a regex-style non-overlapping... the Perl
    ``$count++ while $seq =~ /$npair/g`` scan is non-overlapping per
    pattern, which we reproduce."""
    entropy = 0.0
    n = len(seq)
    if n <= 1:
        return 0.0
    for n1 in "ACTG":
        for n2 in "ACTG":
            pair = n1 + n2
            # non-overlapping regex-global count, like Perl m//g
            count = 0
            i = seq.find(pair)
            while i != -1:
                count += 1
                i = seq.find(pair, i + 2)
            if count == 0:
                continue
            p = count / (n - 1)
            entropy -= p * math.log(p) / math.log(2)
    return entropy


class Repeats:
    """Binned repeat regions (``annotate_fusions.pl:1296-1330``)."""

    def __init__(self, path: str | None):
        self.binned: dict[str, dict[int, list]] = {}
        self.bin_spacing = 1
        if path is None:
            return
        repeat_list = []
        length_sum = 0
        with open(path) as fh:
            for line in fh:
                f = line.rstrip("\n").split("\t")
                chromosome, start, end = f[0], int(f[1]), int(f[2])
                rtype = f[3] if len(f) > 3 else ""
                repeat_list.append((chromosome, start, end, rtype))
                length_sum += end - start
        if not repeat_list:
            return
        self.bin_spacing = max(1, int(length_sum / len(repeat_list) * 5))
        for chromosome, start, end, rtype in repeat_list:
            by_chrom = self.binned.setdefault(chromosome, {})
            for b in range(start // self.bin_spacing,
                           end // self.bin_spacing + 1):
                by_chrom.setdefault(b, []).append((start, end, rtype))

    def proportion(self, chromosome: str, regions) -> float:
        """``get_repeat_proportion``: MAX single overlap size over total
        region length (``annotate_fusions.pl:1267-1290``)."""
        overlaps = [0]
        by_chrom = self.binned.get(chromosome, {})
        for start, end in regions:
            for b in range(start // self.bin_spacing,
                           end // self.bin_spacing + 1):
                for rs, re_, _t in by_chrom.get(b, ()):
                    if not (re_ < start or rs > end):
                        size1 = re_ - rs + 1
                        size2 = end - start + 1
                        ov = min(end - rs + 1, re_ - start + 1, size1,
                                 size2)
                        overlaps.append(max(0, ov))
        total = sum(e - s + 1 for s, e in regions)
        return max(overlaps) / total if total else 0.0


class PslBlocks:
    """Per-(cluster, gene) PSL block lists from exons/cds alignments
    (``find_alignregion``, ``annotate_fusions.pl:508-556``)."""

    def __init__(self):
        self.strand: dict = {}
        self.query: dict = {}
        self.target: dict = {}

    def load(self, psl_lines, fusion_gene_lookup):
        for line in psl_lines:
            f = line.rstrip("\n").split("\t")
            strand = f[8]
            cluster_id = int(f[9])
            query_size = int(f[10])
            target_name = f[13]
            target_size = int(f[14])
            block_sizes = [int(x) for x in f[18].rstrip(",").split(",")]
            q_starts = [int(x) for x in f[19].rstrip(",").split(",")]
            t_starts = [int(x) for x in f[20].rstrip(",").split(",")]
            gene = target_name.split("|", 1)[0]
            if gene not in fusion_gene_lookup.get(cluster_id, ()):
                continue
            for bs, qs, ts in zip(block_sizes, q_starts, t_starts):
                if strand == "-":
                    q_start = query_size - qs - bs + 1
                    q_end = query_size - qs
                else:
                    q_start = qs + 1
                    q_end = qs + bs
                key = (cluster_id, gene)
                self.strand.setdefault(key, []).append(strand)
                self.query.setdefault(key, []).append(
                    (q_start, q_end, query_size))
                self.target.setdefault(key, []).append(
                    (ts + 1, ts + bs, target_size, target_name))


def find_breakseqs_percident(psl_lines, max_ins=None):
    """Max percent identity per cluster (``annotate_fusions.pl:1035-1066``)."""
    out: dict[int, float] = {}
    for line in psl_lines:
        f = line.rstrip("\n").split("\t")
        num_matches = int(f[0])
        target_inserted = int(f[7])
        cluster_id = int(f[9])
        seq_length = int(f[10])
        if max_ins is not None and target_inserted > max_ins:
            continue
        pid = num_matches / seq_length
        out[cluster_id] = max(out.get(cluster_id, 0.0), pid)
    return out


def find_breakseqs_overlap(psl_lines, min_percident, max_left_end,
                           min_right_start):
    """Breakpoint homology extents (``annotate_fusions.pl:1068-1106``)."""
    for line in psl_lines:
        f = line.rstrip("\n").split("\t")
        num_matches = int(f[0])
        cluster_id = int(f[9])
        query_size = int(f[10])
        query_start = int(f[11]) + 1
        query_end = int(f[12])
        pid = num_matches / (query_end - query_start + 1)
        if pid < min_percident:
            continue
        if query_start == 1:
            max_left_end[cluster_id] = max(
                max_left_end.get(cluster_id, query_end), query_end)
        if query_end == query_size:
            min_right_start[cluster_id] = min(
                min_right_start.get(cluster_id, query_start), query_start)


def _read_psl(path):
    if path is None:
        return []
    with open(path) as fh:
        return fh.read().splitlines()


def annotate_fusions(*, breaks, seqs, clusters, gene_models: GeneModels,
                     genome: FastaStore, repeats: Repeats,
                     expression: dict[str, float],
                     read_stats, library_name: str,
                     mapping_stats: dict,
                     psl_genome=None, psl_genome_nointron=None,
                     psl_cdna=None, psl_est=None, psl_estisland=None,
                     psl_exons=None, psl_cds=None, est_alignments=None,
                     percident_threshold=0.90,
                     splicing_index=None, interrupted_index=None):
    """Produce annotation rows.

    breaks: {cluster_id: {end: (ref_name, strand, breakpos)}}
    seqs: {cluster_id: sequence-with-bar}
    clusters: {cluster_id: {end: {fragment_id: (start, end)}}}
    Returns list of "id\\tkey\\tvalue" strings.
    """
    # fusion regions from cluster extents + breakpos
    fusion_align_region: dict = {}
    fusion_region: dict = {}
    for cid, ends in clusters.items():
        if cid not in breaks:
            continue
        for end, frags in ends.items():
            lo = min(s for s, _ in frags.values())
            hi = max(e for _, e in frags.values())
            fusion_align_region[(cid, end)] = (lo, hi)
            _ref, strand, break_pos = breaks[cid][end]
            if strand == "+":
                region = (min(lo, break_pos), break_pos)
            else:
                region = (break_pos, max(hi, break_pos))
            fusion_region[(cid, end)] = region

    # per-cluster breakpoint info
    info: dict[int, dict] = {}
    splice_variants: dict = {}
    fusion_gene_lookup: dict[int, set] = {}
    for cid in sorted(breaks):
        if cid not in clusters:
            continue
        ref1, strand1, pos1 = breaks[cid][0]
        ref2, strand2, pos2 = breaks[cid][1]
        gene1 = gene_models.calc_gene(ref1, pos1)
        gene2 = gene_models.calc_gene(ref2, pos2)
        gpos1 = gene_models.calc_genomic_position(ref1, pos1)
        gpos2 = gene_models.calc_genomic_position(ref2, pos2)
        gstrand1 = gene_models.calc_genomic_strand(ref1, strand1)
        gstrand2 = gene_models.calc_genomic_strand(ref2, strand2)
        loc1 = gene_models.calc_gene_location(gene1, gpos1)
        loc2 = gene_models.calc_gene_location(gene2, gpos2)
        galign1 = gene_models.calc_genomic_regions(
            ref1, fusion_align_region[(cid, 0)])
        galign2 = gene_models.calc_genomic_regions(
            ref2, fusion_align_region[(cid, 1)])
        gregions1 = gene_models.calc_genomic_regions(
            ref1, fusion_region[(cid, 0)])
        gregions2 = gene_models.calc_genomic_regions(
            ref2, fusion_region[(cid, 1)])
        chrom1 = gene_models.calc_genomic_chromosome(ref1)
        chrom2 = gene_models.calc_genomic_chromosome(ref2)

        rep1 = repeats.proportion(chrom1, galign1)
        rep2 = repeats.proportion(chrom2, galign2)

        if gene1 < gene2:
            gs_a, gs_b = gene1 + strand1, gene2 + strand2
            bp_a, bp_b = gpos1, gpos2
        else:
            gs_a, gs_b = gene2 + strand2, gene1 + strand1
            bp_a, bp_b = gpos2, gpos1
        splice_variants.setdefault((gs_a, gs_b), set()).add(
            f"{bp_a}-{bp_b}")

        sequence = seqs.get(cid, "N")
        if sequence in ("N", ""):
            continue
        bar = sequence.find("|")
        if bar < 0:
            continue
        seq_nobar = sequence.replace("|", "")

        adj1 = seq_nobar[max(0, bar - ENTROPY_ADJACENT):
                         max(0, bar - ENTROPY_ADJACENT)
                         + min(bar, ENTROPY_ADJACENT)]
        adj2 = seq_nobar[bar:bar + min(len(seq_nobar) - bar,
                                       ENTROPY_ADJACENT)]

        fusion_gene_lookup[cid] = {gene1, gene2}
        info[cid] = dict(
            gene1=gene1, gene2=gene2, ref1=ref1, ref2=ref2,
            strand1=strand1, strand2=strand2,
            gpos1=gpos1, gpos2=gpos2, gstrand1=gstrand1,
            gstrand2=gstrand2, loc1=loc1, loc2=loc2,
            gregions1=gregions1, gregions2=gregions2,
            rep1=rep1, rep2=rep2,
            entropy1=calc_entropy(adj1), entropy2=calc_entropy(adj2),
            seq_length=len(seq_nobar), seq1_length=bar,
            seq2_length=len(seq_nobar) - bar,
            gs_key=(gs_a, gs_b))

    # span counts / coverage
    span_count: dict[int, int] = {}
    span_coverage: dict = {}
    min_coverage = read_stats.fraglength_mean - read_stats.readlength_min
    for cid in info:
        for end, frags in clusters[cid].items():
            span_count[cid] = len(frags)
            covered = set()
            for s, e in frags.values():
                covered.update(range(s, e + 1))
            span_coverage[(cid, end)] = len(covered) / min_coverage

    # PSL-derived features
    exon_blocks = PslBlocks()
    exon_blocks.load(_read_psl(psl_exons), fusion_gene_lookup)
    cds_blocks = PslBlocks()
    cds_blocks.load(_read_psl(psl_cds), fusion_gene_lookup)

    if psl_estisland is not None:
        estisland_lines = _read_psl(psl_estisland)
    elif est_alignments is not None and psl_genome is not None:
        # run the EST-island containment filter in-process
        # (annotate_fusions.pl:1108-1132 shells out to estislands)
        from ..filters.estislands import EstCatalog
        cat = EstCatalog()
        with open(est_alignments) as fh:
            cat.read_ests(fh)
        estisland_lines = list(cat.filter_contained(_read_psl(psl_genome)))
    else:
        estisland_lines = []

    percident = {
        "genome": find_breakseqs_percident(_read_psl(psl_genome),
                                           GENOME_MAX_INS),
        "cdna": find_breakseqs_percident(_read_psl(psl_cdna),
                                         CDNA_MAX_INS),
        "est": find_breakseqs_percident(_read_psl(psl_est), EST_MAX_INS),
        "estisland": find_breakseqs_percident(estisland_lines),
    }
    max_left_end: dict[int, int] = {}
    min_right_start: dict[int, int] = {}
    find_breakseqs_overlap(_read_psl(psl_genome_nointron),
                           percident_threshold, max_left_end,
                           min_right_start)
    find_breakseqs_overlap(_read_psl(psl_cdna), percident_threshold,
                           max_left_end, min_right_start)

    homology: dict[int, int] = {}
    for cid in info:
        for ref_type in ("genome", "cdna", "est", "estisland"):
            if cid not in percident[ref_type]:
                continue
            mismatches = (1 - percident[ref_type][cid]) \
                * info[cid]["seq_length"]
            adjusted = 1 - mismatches / min(info[cid]["seq1_length"],
                                            info[cid]["seq2_length"])
            percident[ref_type][cid] = max(0, adjusted)
        homology[cid] = 0
        if cid in max_left_end and cid in min_right_start:
            homology[cid] = max(0, max_left_end[cid]
                                - min_right_start[cid] + 1)

    raw_genome_percident = find_breakseqs_percident(_read_psl(psl_genome))

    # emit rows
    rows: list[str] = []

    def put(cid, key, value):
        rows.append(f"{cid}\t{key}\t{value}")

    for cid in sorted(info):
        d = info[cid]
        gene1, gene2 = d["gene1"], d["gene2"]
        g1 = gene_models.genes[gene1]
        g2 = gene_models.genes[gene2]
        transcript1 = d["ref1"] if gene_models.is_transcript(d["ref1"]) \
            else "NA"
        transcript2 = d["ref2"] if gene_models.is_transcript(d["ref2"]) \
            else "NA"

        # orf phase check (annotate_fusions.pl:686-715)
        orf = "N"
        key1 = (cid, gene1)
        key2 = (cid, gene2)
        for s1, q1, t1 in zip(cds_blocks.strand.get(key1, []),
                              cds_blocks.query.get(key1, []),
                              cds_blocks.target.get(key1, [])):
            for s2, q2, t2 in zip(cds_blocks.strand.get(key2, []),
                                  cds_blocks.query.get(key2, []),
                                  cds_blocks.target.get(key2, [])):
                if s1 != s2:
                    continue
                query_phase = (q1[0] - q2[0]) % 3
                if s1 == "+":
                    target_phase = (t1[0] - t2[0]) % 3
                else:
                    target_phase = (t1[1] - t2[1]) % 3
                if query_phase == target_phase:
                    orf = "Y"

        # exon boundary snap (annotate_fusions.pl:717-818)
        exonboundaries = "N"
        gpos1, gpos2 = d["gpos1"], d["gpos2"]
        done = False
        for s1, q1, t1 in zip(exon_blocks.strand.get(key1, []),
                              exon_blocks.query.get(key1, []),
                              exon_blocks.target.get(key1, [])):
            for s2, q2, t2 in zip(exon_blocks.strand.get(key2, []),
                                  exon_blocks.query.get(key2, []),
                                  exon_blocks.target.get(key2, [])):
                if q1[1] + 1 == q2[0]:
                    end1_ok = (t1[1] == t1[2]) if s1 == "+" else \
                        (t1[0] == 1)
                    end1_pos = t1[2] if s1 == "+" else 1
                    start2_ok = (t2[0] == 1) if s2 == "+" else \
                        (t2[1] == t2[2])
                    start2_pos = 1 if s2 == "+" else t2[2]
                    if end1_ok and start2_ok:
                        exonboundaries = "Y"
                        gpos1 = gene_models.exon_to_genome(t1[3], end1_pos)
                        gpos2 = gene_models.exon_to_genome(t2[3],
                                                           start2_pos)
                        done = True
                        break
                elif q2[1] + 1 == q1[0]:
                    end2_ok = (t2[1] == t2[2]) if s2 == "+" else \
                        (t2[0] == 1)
                    end2_pos = t2[2] if s2 == "+" else 1
                    start1_ok = (t1[0] == 1) if s1 == "+" else \
                        (t1[1] == t1[2])
                    start1_pos = 1 if s1 == "+" else t1[2]
                    if end2_ok and start1_ok:
                        exonboundaries = "Y"
                        gpos1 = gene_models.exon_to_genome(t1[3],
                                                           start1_pos)
                        gpos2 = gene_models.exon_to_genome(t2[3], end2_pos)
                        done = True
                        break
            if done:
                break

        # splice score (annotate_fusions.pl:820-832, 96-114)
        def splice_seq(chromosome, position, strand):
            if strand == "+":
                seq, _, _ = genome.get(chromosome, 0, position + 1, 2)
            else:
                seq, _, _ = genome.get(chromosome, 0, position - 2, 2)
                seq = revcomp(seq)
            return seq

        sseq1 = splice_seq(g1.chromosome, gpos1, d["gstrand1"])
        sseq2 = splice_seq(g2.chromosome, gpos2, d["gstrand2"])
        seqf = sseq1 + revcomp(sseq2)
        seqr = sseq2 + revcomp(sseq1)

        def edit_dist(a, b):
            return sum(1 for x, y in zip(a, b) if x != y)

        splice_score = 4 - min(edit_dist("GTAG", seqf),
                               edit_dist("GTAG", seqr),
                               edit_dist("ATAC", seqf),
                               edit_dist("ATAC", seqr))

        adjacent = "Y" if gene2 in gene_models.adjacent.get(gene1, ()) \
            else "N"
        interchromosomal = "Y" if g1.chromosome != g2.chromosome else "N"
        inversion = "Y" if interchromosomal == "N" \
            and d["gstrand1"] == d["gstrand2"] else "N"
        eversion = "N"
        if interchromosomal == "N":
            if g1.region[0] < g2.region[0] and d["gstrand1"] == "-" \
                    and d["gstrand2"] == "+":
                eversion = "Y"
            if g1.region[0] > g2.region[0] and d["gstrand1"] == "+" \
                    and d["gstrand2"] == "-":
                eversion = "Y"
        deletion = "Y" if (interchromosomal == "N" and inversion == "N"
                           and eversion == "N") else "N"
        read_through = "Y" if deletion == "Y" and adjacent == "Y" else "N"

        num_splice_variants = len(splice_variants[d["gs_key"]])
        gene_align_strand1 = "+" if d["gstrand1"] == g1.strand else "-"
        gene_align_strand2 = "+" if d["gstrand2"] == g2.strand else "-"

        def region_join(regions, idx):
            joined = ",".join(str(r[idx]) for r in regions)
            return joined if joined else "NA"

        put(cid, "library_name", library_name)
        put(cid, "gene1", gene1)
        put(cid, "transcript1", transcript1)
        put(cid, "gene_name1", g1.name)
        put(cid, "gene_chromosome1", g1.chromosome)
        put(cid, "gene_strand1", g1.strand)
        put(cid, "gene_start1", g1.region[0])
        put(cid, "gene_end1", g1.region[1])
        put(cid, "gene2", gene2)
        put(cid, "transcript2", transcript2)
        put(cid, "gene_name2", g2.name)
        put(cid, "gene_chromosome2", g2.chromosome)
        put(cid, "gene_strand2", g2.strand)
        put(cid, "gene_start2", g2.region[0])
        put(cid, "gene_end2", g2.region[1])
        put(cid, "gene_align_strand1", gene_align_strand1)
        put(cid, "gene_align_strand2", gene_align_strand2)
        put(cid, "genomic_break_pos1", gpos1)
        put(cid, "genomic_break_pos2", gpos2)
        put(cid, "genomic_strand1", d["gstrand1"])
        put(cid, "genomic_strand2", d["gstrand2"])
        put(cid, "genomic_starts1", region_join(d["gregions1"], 0))
        put(cid, "genomic_starts2", region_join(d["gregions2"], 0))
        put(cid, "genomic_ends1", region_join(d["gregions1"], 1))
        put(cid, "genomic_ends2", region_join(d["gregions2"], 1))
        si = splicing_index or {}
        ii = interrupted_index or {}
        put(cid, "splicing_index1", si.get((cid, 0), "-"))
        put(cid, "splicing_index2", si.get((cid, 1), "-"))
        put(cid, "interrupted_index1", ii.get((cid, 0), "-"))
        put(cid, "interrupted_index2", ii.get((cid, 1), "-"))
        put(cid, "span_coverage1", _perl_num(span_coverage[(cid, 0)]))
        put(cid, "span_coverage2", _perl_num(span_coverage[(cid, 1)]))
        # expression values pass through verbatim from the expression
        # file (the reference echoes the parsed string)
        put(cid, "expression1", expression.get(gene1, 0))
        put(cid, "expression2", expression.get(gene2, 0))
        put(cid, "gene_location1", d["loc1"])
        put(cid, "gene_location2", d["loc2"])
        put(cid, "orf", orf)
        put(cid, "exonboundaries", exonboundaries)
        put(cid, "adjacent", adjacent)
        put(cid, "interchromosomal", interchromosomal)
        put(cid, "inversion", inversion)
        put(cid, "eversion", eversion)
        put(cid, "deletion", deletion)
        put(cid, "read_through", read_through)
        altsplice = "Y" if raw_genome_percident.get(cid, 0) \
            > percident_threshold else "N"
        put(cid, "altsplice", altsplice)
        put(cid, "span_count", span_count[cid])
        put(cid, "genome_breakseqs_percident",
            _perl_num(percident["genome"].get(cid, 0)))
        put(cid, "cdna_breakseqs_percident",
            _perl_num(percident["cdna"].get(cid, 0)))
        put(cid, "est_breakseqs_percident",
            _perl_num(percident["est"].get(cid, 0)))
        put(cid, "breakseqs_estislands_percident",
            _perl_num(percident["estisland"].get(cid, 0)))
        put(cid, "break_adj_entropy1", _perl_num(d["entropy1"]))
        put(cid, "break_adj_entropy2", _perl_num(d["entropy2"]))
        put(cid, "breakpoint_homology", homology[cid])
        put(cid, "break_adj_entropy_min",
            _perl_num(min(d["entropy1"], d["entropy2"])))
        put(cid, "span_coverage_min",
            _perl_num(min(span_coverage[(cid, 0)],
                          span_coverage[(cid, 1)])))
        put(cid, "span_coverage_max",
            _perl_num(max(span_coverage[(cid, 0)],
                          span_coverage[(cid, 1)])))
        put(cid, "repeat_proportion1", _perl_num(d["rep1"]))
        put(cid, "repeat_proportion2", _perl_num(d["rep2"]))
        put(cid, "max_repeat_proportion",
            _perl_num(max(d["rep1"], d["rep2"])))
        put(cid, "splice_score", splice_score)
        put(cid, "num_splice_variants", num_splice_variants)
        ms = mapping_stats.get(cid, {})
        put(cid, "min_map_count", ms.get("min_map_count", 0))
        put(cid, "max_map_count", ms.get("max_map_count", 0))
        put(cid, "mean_map_count", ms.get("mean_map_count", 0))
        put(cid, "num_multi_map", ms.get("num_multi_map", 0))

    return rows
