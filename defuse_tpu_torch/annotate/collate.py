"""Results assembly — ``scripts/coallate_fusions.pl`` equivalent.

Joins breakpoint sequences, p-values and annotations into results.tsv:
header ``cluster_id, splitr_sequence, splitr_count, splitr_span_pvalue,
splitr_pos_pvalue, splitr_min_pvalue, <sorted annotation keys>`` with
every row tab-terminated (``coallate_fusions.pl:122-160``).  Rows emit in
ascending cluster id (the reference iterates a Perl hash; canonical
order here).
"""

from __future__ import annotations


def collate(cluster_ids, seqs, span_pvalues, split_pvalues, annotations,
            out):
    """seqs: {cid: (sequence, split_count)}; span_pvalues: {cid: str};
    split_pvalues: {cid: (pos_pvalue, min_pvalue)} (values preformatted
    strings); annotations: {cid: {key: value}}."""
    anno_types = sorted({k for a in annotations.values() for k in a})
    out.write("cluster_id\t")
    out.write("splitr_sequence\tsplitr_count\tsplitr_span_pvalue\t"
              "splitr_pos_pvalue\tsplitr_min_pvalue\t")
    out.write("\t".join(anno_types) + ("\t" if anno_types else ""))
    out.write("\n")
    for cid in sorted(cluster_ids):
        anno = annotations.get(cid, {})
        seq, count = seqs[cid]
        pos_p, min_p = split_pvalues[cid]
        fields = [str(cid), seq, str(count), str(span_pvalues[cid]),
                  str(pos_p), str(min_p)]
        fields += [str(anno.get(t, "")) for t in anno_types]
        out.write("\t".join(fields) + "\t\n")


def filter_by_probability(results_path, out_path, threshold: float):
    """``filter.pl probability > threshold`` equivalent."""
    with open(results_path) as fh, open(out_path, "w") as out:
        header = fh.readline()
        out.write(header)
        cols = header.rstrip("\n").split("\t")
        pidx = cols.index("probability")
        for line in fh:
            fields = line.rstrip("\n").split("\t")
            if float(fields[pidx]) > threshold:
                out.write(line)
