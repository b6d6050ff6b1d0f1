"""Per-gene exonic expression plot — the ``expression_plot.pl`` /
``expression_plot.R`` equivalent (reference scripts, 434+35 lines).

Coverage of a gene's transcripts is piled up from the concordant pair
SAM, remapped to genomic coordinates, unioned over the gene's merged
exonic regions, and plotted against merged-exonic position with the
fusion breakpoint (from ``results.tsv``) marked by a red segment and a
strand arrow.  The position/expression table always lands next to the
plot as ``<plot>.expr.tsv`` (the reference wrote the same table to a tmp
file for R); the plot itself renders with matplotlib when available.
"""

from __future__ import annotations

import pathlib

import numpy as np

from ..core.exons import ExonRegions


def merge_regions(regions):
    """Union of (start, end) intervals, ascending
    (``expression_plot.pl::merge_regions``)."""
    out: list[list[int]] = []
    for s, e in sorted(regions):
        if out and s <= out[-1][1] + 1:
            out[-1][1] = max(out[-1][1], e)
        else:
            out.append([s, e])
    return [(s, e) for s, e in out]


def merged_transcript_position(regions, strand, gpos):
    """Genomic -> merged-exonic position; intronic positions snap to the
    next exon start (``gene_models.pm:536-570`` semantics on the fake
    merged transcript the reference builds)."""
    length = sum(e - s + 1 for s, e in regions)
    local = 0
    tpos = None
    for es, ee in regions:
        if gpos < es:
            tpos = local + 1
            break
        if gpos <= ee:
            tpos = gpos - es + local + 1
            break
        local += ee - es + 1
    if tpos is None:
        tpos = length
    if strand == 1:
        tpos = length - tpos + 1
    return tpos


def exonic_expression(concordant_sam: str, exon_regions: ExonRegions,
                      gene_id: str):
    """(expression array over merged-exonic positions 1..L, merged
    regions, gene strand)."""
    from ..io.sam import iter_sam

    transcripts = exon_regions.gene_transcripts(gene_id)
    # per-transcript pileup from the concordant SAM
    cov_by_ref: dict[str, np.ndarray] = {}
    wanted = {}
    for t in transcripts:
        wanted[f"{gene_id}|{t}"] = t
        wanted[t] = t
    for rec in iter_sam(concordant_sam):
        t = wanted.get(rec.reference)
        if t is None:
            continue
        length = exon_regions.transcript_length(t)
        cov = cov_by_ref.get(t)
        if cov is None:
            cov = cov_by_ref[t] = np.zeros(length + 2, dtype=np.int64)
        s = max(1, rec.start)
        e = min(length, rec.end)
        if s <= e:
            cov[s] += 1
            cov[e + 1] -= 1

    # genomic accumulation over all transcripts
    genomic_cov: dict[int, int] = {}
    strand = None
    all_exons = []
    for t in transcripts:
        tr = exon_regions._transcripts[t]
        strand = tr.strand
        all_exons.extend(tr.exons)
        cov = cov_by_ref.get(t)
        if cov is None:
            continue
        depth = np.cumsum(cov[1:-1])
        for tpos in np.nonzero(depth)[0]:
            _c, _s, gpos = exon_regions.remap_transcript_to_genome(
                t, 0, int(tpos) + 1)
            genomic_cov[gpos] = genomic_cov.get(gpos, 0) \
                + int(depth[tpos])

    regions = merge_regions(all_exons)
    length = sum(e - s + 1 for s, e in regions)
    expr = np.zeros(length + 1, dtype=np.int64)  # 1-based
    for gpos, depth in genomic_cov.items():
        epos = merged_transcript_position(regions, strand, gpos)
        if 1 <= epos <= length:
            expr[epos] += depth
    return expr[1:], regions, strand


def find_fusion_breakpos(results_path: str, fusion_id: int,
                         gene_id: str):
    """(genomic_break_pos, genomic_strand) for the gene in the fusion
    row (``expression_plot.pl:81-135``)."""
    with open(results_path) as fh:
        header = fh.readline().rstrip("\n").split("\t")
        idx = {name: i for i, name in enumerate(header)}
        for line in fh:
            f = line.rstrip("\n").split("\t")
            if int(f[idx["cluster_id"]]) != fusion_id:
                continue
            for n in ("1", "2"):
                if f[idx[f"gene{n}"]] == gene_id:
                    return (int(f[idx[f"genomic_break_pos{n}"]]),
                            f[idx[f"genomic_strand{n}"]])
            raise ValueError(
                f"fusion {fusion_id} is between "
                f"{f[idx['gene1']]} and {f[idx['gene2']]}")
    raise ValueError(f"unable to find fusion {fusion_id}")


def expression_plot(*, concordant_sam: str, cdna_regions: str,
                    gene_id: str, out_path: str,
                    results_path: str | None = None,
                    fusion_id: int | None = None) -> dict:
    er = ExonRegions.from_file(cdna_regions)
    expr, regions, strand = exonic_expression(concordant_sam, er,
                                              gene_id)

    break_epos = break_dir = None
    if fusion_id is not None and results_path:
        gpos, gstrand = find_fusion_breakpos(results_path, fusion_id,
                                             gene_id)
        break_epos = merged_transcript_position(regions, strand, gpos)
        gene_strand = "+" if strand == 0 else "-"
        break_dir = 1 if gstrand == gene_strand else -1

    out = pathlib.Path(out_path)
    out.parent.mkdir(parents=True, exist_ok=True)
    table = out.with_name(out.name + ".expr.tsv")
    with open(table, "w") as fh:
        fh.write("position\texpression\n")
        for i, v in enumerate(expr, start=1):
            fh.write(f"{i}\t{v}\n")

    plotted = False
    try:
        import matplotlib
        matplotlib.use("Agg")
        import matplotlib.pyplot as plt

        pos = np.arange(1, len(expr) + 1)
        fig, ax = plt.subplots(figsize=(8, 5))
        # zero-padded endpoints like expression_plot.R
        ax.plot(np.concatenate([[pos[0]], pos, [pos[-1]]]),
                np.concatenate([[0], expr, [0]]), color="black", lw=1)
        if break_epos is not None:
            lo, hi = float(expr.min()), float(expr.max())
            ax.plot([break_epos, break_epos], [lo, hi], color="red",
                    lw=3)
            mid = (lo + hi) / 2
            arrowlen = (pos[-1] - pos[0]) * 0.1
            start = break_epos - break_dir * arrowlen
            ax.annotate("", xy=(break_epos, mid), xytext=(start, mid),
                        arrowprops=dict(color="red", lw=3,
                                        arrowstyle="->"))
        ax.set_xlabel("Position")
        ax.set_ylabel("Expression")
        fig.savefig(out)
        plt.close(fig)
        plotted = True
    except ImportError:
        pass
    return {"table": str(table), "plot": str(out) if plotted else None,
            "break_position": break_epos}
