"""The comparison that decides ``correct``: a run's output (``observe``)
against the plain reference (``reference``).

Two numbers are compared, each with its own limit in ``LIMITS``:

* ``frontend_pairs_differ``: pairs the frontend split otherwise than the
  reference (spanning, improper, the concordant count);
* ``fusion_disagreements``: planted fusions with no discover cluster
  (``splitreads.break``) at an allowed breakpoint, and clusters at none;
  planted fusions with no row of ``results.tsv`` at an allowed breakpoint,
  and rows at none.

The four parts of the second are printed beside it, and
``span_count_gap`` (the largest relative gap between a row's
``span_count`` and the fusion's spanning pairs) is printed and not
compared: deFuse's mate-pair clustering drops pairs of outlying fragment
length, which the reference does not model."""

from __future__ import annotations

import numpy as np

from observe import gene_id, in_gene
from reference import CONCORDANT, IMPROPER, SPANNING

# name: the largest reading that passes, set from sound runs and a control
# (PERF.md section 2).  frontend_pairs_differ: sound runs 0, the control with
# exact alignment 682 or more in the dense mix, 92 or more in a mix of 30
# fusions with 0.1% decoys.  fusion_disagreements: sound runs 0-4 (4: a
# fusion whose split alignment takes a mismatch at an exon's edge, which
# the reference does not follow), the control with each breakpoint a base
# past its slides 384 (the dense mix), 120 (that sparser mix).
LIMITS = {"frontend_pairs_differ": 50, "fusion_disagreements": 12}

def _at(genes, fusion, allowed, first, second) -> bool:
    """Whether two sides (``(ref, pos)`` each) are fusion ``fusion``'s
    breakpoint, in either order."""
    ga, gb = fusion
    return any((pa, pb) in allowed
               for x, y in ((first, second), (second, first))
               for pa in in_gene(genes, ga, *x)
               for pb in in_gene(genes, gb, *y))


def numbers(obs, exp, genes) -> dict:
    """Each compared number of one library (and ``span_count_gap``)."""
    differ = 0
    for cls in (SPANNING, IMPROPER):
        differ += int(np.count_nonzero((obs.classes == cls) !=
                                       (exp.classes == cls)))
    differ += abs(obs.n_concordant - int((exp.classes == CONCORDANT).sum()))

    planted = list(zip(exp.gene_ids, exp.breakpoints))
    found = [[_at(genes, fusion, allowed, *b) for b in obs.breaks]
             for fusion, allowed in planted]
    breaks_missed = sum(not any(row) for row in found)
    breaks_extra = sum(not any(col) for col in zip(*found)) if found else \
        len(obs.breaks)

    matched = np.zeros(len(planted), np.int64)
    extra, gap = 0, 0.0
    for row in obs.results:
        sides = [(str(genes.chrom[gene_id(row[f"gene{i}"])]),
                  int(row[f"genomic_break_pos{i}"])) for i in (1, 2)]
        hits = [f for f, (fusion, allowed) in enumerate(planted)
                if {gene_id(row["gene1"]), gene_id(row["gene2"])} ==
                set(fusion) and _at(genes, fusion, allowed, *sides)]
        if not hits:
            extra += 1
            continue
        f = hits[0]
        matched[f] += 1
        want = int(exp.span_counts[f])
        gap = max(gap, abs(int(row["span_count"]) - want) / max(want, 1))
    parts = {
        "discover_breaks_missed": breaks_missed,
        "discover_breaks_extra": breaks_extra,
        "results_missed": int(np.count_nonzero(matched == 0)),
        "results_extra": extra,
    }
    return {"frontend_pairs_differ": differ} | parts | {
        "fusion_disagreements": sum(parts.values()),
        "span_count_gap": round(gap, 6)}


def judge(readings: list[dict]) -> tuple[bool, dict]:
    """The worst reading of each compared number over the libraries
    checked, and whether every one is within its limit."""
    worst = {k: max(r[k] for r in readings) for k in LIMITS} if readings \
        else {}
    ok = bool(readings) and all(worst[k] <= LIMITS[k] for k in LIMITS)
    return ok, worst
