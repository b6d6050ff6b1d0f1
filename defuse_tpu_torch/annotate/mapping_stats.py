"""Per-cluster mapping-count statistics — the
``scripts/calculate_mapping_stats.pl`` equivalent.

For each spanning read of a set-cover cluster fragment, counts distinct
genomic alignment loci (alignments remapped through transcripts to the
genome; overlapping loci greedily merged, processed in ascending
alignment order — the Perl iterates hash keys, i.e. non-deterministically
for non-transitive overlap graphs; ascending order is our canonical
contract).  Per cluster: min/max/mean of per-fragment
``count_end1 * count_end2`` and the number of multi-mapping fragments.
"""

from __future__ import annotations

from ..stats.readstats import _perl_num
from .gene_models import GeneModels

BIN_SPACING = 200000


def mapping_stats(spanning_rows, solution_clusters: dict[int, int],
                  gene_models: GeneModels):
    """spanning_rows: iterable of (fragment, read_end0, ref, strand,
    start, end); solution_clusters: {fragment: cluster_id}.

    Returns {cluster_id: {key: value}} with Perl-formatted values.
    """
    genome_positions: dict[tuple[int, int], list] = {}
    for (fragment, read_end, ref, _strand, start, end) in spanning_rows:
        if fragment not in solution_clusters:
            continue
        chromosome = gene_models.calc_genomic_chromosome(ref)
        g_start = gene_models.calc_genomic_position(ref, start)
        g_end = gene_models.calc_genomic_position(ref, end)
        if g_start > g_end:
            g_start, g_end = g_end, g_start
        genome_positions.setdefault((fragment, read_end + 1), []).append(
            (chromosome, g_start, g_end))

    align_counts: dict[int, dict[int, int]] = {}
    for (fragment, read_end), positions in genome_positions.items():
        # overlap graph via binning
        bins: dict[tuple[str, int], list[int]] = {}
        for i, (chrom, s, e) in enumerate(positions):
            for b in range(s // BIN_SPACING, e // BIN_SPACING + 1):
                bins.setdefault((chrom, b), []).append(i)
        overlapping: dict[int, set[int]] = {}
        for members in bins.values():
            for i in members:
                for j in members:
                    if not (positions[i][2] < positions[j][1]
                            or positions[i][1] > positions[j][2]):
                        overlapping.setdefault(i, set()).add(j)
        count = 0
        remaining = dict(sorted(overlapping.items()))
        while remaining:
            i = next(iter(remaining))
            for j in list(remaining[i]):
                remaining.pop(j, None)
            count += 1
        align_counts.setdefault(fragment, {})[read_end] = count

    per_cluster: dict[int, list[int]] = {}
    for fragment, ends in align_counts.items():
        cid = solution_clusters[fragment]
        count = ends.get(1, 0) * ends.get(2, 0)
        per_cluster.setdefault(cid, []).append(count)

    out: dict[int, dict] = {}
    for cid, counts in per_cluster.items():
        mean = sum(counts) / len(counts)
        out[cid] = {
            "min_map_count": min(counts),
            "max_map_count": max(counts),
            "mean_map_count": _perl_num(mean),
            "num_multi_map": sum(1 for c in counts if c > 1),
        }
    return out
