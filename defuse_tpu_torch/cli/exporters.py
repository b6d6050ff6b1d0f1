"""Result exporters and format converters (reference L9 utilities):
``results_to_circos_links.pl``, ``create_circos_data.pl``,
``qseq2fastq.pl``, ``fq_all2std.pl`` equivalents."""

from __future__ import annotations


def results_to_circos_links(results_path, out, *, filtered_only=False,
                            probability_threshold=0.5):
    """Circos link rows: chromosome/position pairs per fusion."""
    with open(results_path) as fh:
        header = fh.readline().rstrip("\n").split("\t")
        idx = {name: header.index(name) for name in
               ("cluster_id", "gene_chromosome1", "genomic_break_pos1",
                "gene_chromosome2", "genomic_break_pos2")
               if name in header}
        pidx = header.index("probability") if "probability" in header \
            else None
        for line in fh:
            f = line.rstrip("\n").split("\t")
            if filtered_only and pidx is not None and \
                    float(f[pidx]) <= probability_threshold:
                continue
            out.write("hs{} {} {} hs{} {} {}\n".format(
                f[idx["gene_chromosome1"]],
                f[idx["genomic_break_pos1"]],
                int(f[idx["genomic_break_pos1"]]) + 1,
                f[idx["gene_chromosome2"]],
                f[idx["genomic_break_pos2"]],
                int(f[idx["genomic_break_pos2"]]) + 1))


def expression_to_circos_points(expression: dict[str, float],
                                gene_models, out):
    """Per-gene expression as circos scatter points."""
    for gene in sorted(expression):
        if gene not in gene_models.genes:
            continue
        g = gene_models.genes[gene]
        out.write(f"hs{g.chromosome} {g.region[0]} {g.region[1]} "
                  f"{expression[gene]}\n")


def results_to_circos_link_rows(results_lines, out):
    """Reference-format link rows (``results_to_circos_links.pl``): two
    rows per fusion, ``libname-id<TAB>hs<chr><TAB>pos<TAB>pos``."""
    idx = None
    for line in results_lines:
        f = line.rstrip("\n").split("\t")
        if idx is None:
            idx = {name: i for i, name in enumerate(f)}
            continue
        if f[0] == "cluster_id":
            continue
        tag = f"{f[idx['library_name']]}-{f[idx['cluster_id']]}"
        for end in ("1", "2"):
            chrom = f[idx["gene_chromosome" + end]]
            pos = f[idx["genomic_break_pos" + end]]
            out.write(f"{tag}\ths{chrom}\t{pos}\t{pos}\n")


def filter_equal(lines, column: str, value: str):
    """``filter_equal.pl``: keep header + rows whose named column equals
    ``value`` (used by create_circos_data to split by the orf flag)."""
    idx = None
    for line in lines:
        if idx is None:
            idx = line.rstrip("\n").split("\t").index(column)
            yield line
            continue
        if line.rstrip("\n").split("\t")[idx] == value:
            yield line


def cnv_to_circos_points(cnv_lines, levels, out):
    """``cnv_to_circos_points.pl``: CNV segment rows
    ``chr<TAB>start<TAB>end<TAB>level<TAB>value`` filtered to the given
    levels, chromosome 23 renamed X and hs-prefixed."""
    keep = {str(l) for l in levels}
    for line in cnv_lines:
        chrom, start, end, level, value = \
            line.rstrip("\n").split("\t")[:5]
        chrom = "hs" + chrom.replace("23", "X")
        if level in keep:
            out.write(f"{chrom}\t{start}\t{end}\t{value}\n")


# CNV level groups -> output suffix (create_circos_data.pl:56-60)
CNV_LEVEL_FILES = (
    ((1, 2), "somatic.loss.txt"),
    ((3,), "neut.txt"),
    ((4, 5, 6), "somatic.gain.txt"),
    ((7, 8), "germline.loss.txt"),
    ((9, 10, 11), "germline.gain.txt"),
)


def create_circos_data(results_path, prefix, cnv_path=None):
    """``create_circos_data.pl``: split results by the orf flag into two
    reference-format link files and emit the five CNV level tracks
    (empty when no CNV file is given).  Returns the written paths."""
    import os
    if os.path.basename(str(prefix)) == "circos":
        raise ValueError("prefix cannot be 'circos'")
    written = []
    for orf, n in (("Y", 1), ("N", 2)):
        path = f"{prefix}.{n}.link"
        with open(results_path) as rf, open(path, "w") as out:
            results_to_circos_link_rows(
                filter_equal(rf, "orf", orf), out)
        written.append(path)
    for levels, suffix in CNV_LEVEL_FILES:
        path = f"{prefix}.{suffix}"
        with open(path, "w") as out:
            if cnv_path is not None:
                with open(cnv_path) as cf:
                    cnv_to_circos_points(cf, levels, out)
        written.append(path)
    return written


def qseq2fastq(qseq_lines, out):
    """Illumina qseq -> fastq (``qseq2fastq.pl``): qualities are
    phred64 -> phred33 rebased; '.' bases become N."""
    for line in qseq_lines:
        f = line.rstrip("\n").split("\t")
        name = f"{f[0]}_{f[1]}:{f[2]}:{f[3]}:{f[4]}:{f[5]}#{f[6]}/{f[7]}"
        seq = f[8].replace(".", "N")
        qual = "".join(chr(ord(c) - 64 + 33) for c in f[9])
        out.write(f"@{name}\n{seq}\n+\n{qual}\n")


def solexa_to_std_quality(fastq_lines, out):
    """fq_all2std-style Solexa(+64) -> standard(+33) quality rebase."""
    for i, line in enumerate(fastq_lines):
        if i % 4 == 3:
            line = "".join(chr(max(33, ord(c) - 31))
                           for c in line.rstrip("\n")) + "\n"
        out.write(line)
