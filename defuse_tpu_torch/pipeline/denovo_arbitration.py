"""Split-read vs de novo breakpoint arbitration — the legacy
``scripts/select_breakpoint_seq.pl`` flow backing the ``break_predict`` /
``denovo_*`` output columns.

Per cluster, the prediction source with the higher spanning p-value wins
(``select_breakpoint_seq.pl:29-76``).  The de novo predictions come from
``align/denovo.PathFinder`` assemblies of the cluster's candidate reads.
"""

from __future__ import annotations


def arbitrate(splitr_span_pval: dict[int, float],
              denovo_span_pval: dict[int, float]):
    """Returns {cluster_id: "splitr" | "denovo"}."""
    out: dict[int, str] = {}
    for cid in sorted(set(splitr_span_pval) | set(denovo_span_pval)):
        if cid not in denovo_span_pval:
            out[cid] = "splitr"
        elif cid not in splitr_span_pval:
            out[cid] = "denovo"
        elif denovo_span_pval[cid] > splitr_span_pval[cid]:
            out[cid] = "denovo"
        else:
            out[cid] = "splitr"
    return out
