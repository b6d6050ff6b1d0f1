"""Opt-in de novo breakpoint assembly stage.

The reference 0.8 ships the de Bruijn ``PathFinder`` assembler
(``tools/PathFinder.cpp``) but no longer invokes it; the legacy flow
(``scripts/select_breakpoint_seq.pl``, retired) assembled each cluster's
candidate reads and arbitrated splitr-vs-denovo by spanning p-value.
This stage revives that capability behind ``denovo_assembly = yes``:
per cluster, candidate reads (as nominated for split realignment) are
assembled left-anchored/right-anchored through ``align.denovo.PathFinder``
and written to ``denovo.seq``; the assembly's junction is located against
the cluster's flank pair so a real spanning p-value can be computed for
the denovo breakpoint, and ``select_breakpoint_seq.pl:29-76`` arbitration
decides ``break_predict``.  The documented ``break_predict`` /
``denovo_sequence`` / ``denovo_min_count`` / ``denovo_span_pvalue``
columns (``README.md:276-287``) are emitted into results.tsv as
annotation keys.
"""

from __future__ import annotations

from ..align.denovo import PathFinder
from .denovo_arbitration import arbitrate


def assemble_clusters(candidate_rows, read_lookup, k: int = 21,
                      max_length: int = 500, min_count: int = 2):
    """Assemble a breakpoint sequence per cluster.

    candidate_rows: iterable of (cluster_id, fragment, read_end,
    rev_comp) as produced by the native candidate collection (or the
    Python ``collect_candidates``).  ``read_lookup(fragment, read_end)``
    returns the raw read sequence.  A candidate with ``rev_comp == 1``
    was nominated by a mate on the *left* (cluster end 0) flank — the
    read itself therefore sits downstream, toward/past the junction, so
    it seeds the *right* side of the path search (and vice versa).

    Returns {cluster_id: (sequence, n_reads, min_kmer_count)} for
    assembled clusters.
    """
    from ..core.types import revcomp

    by_cluster: dict[int, list[tuple[str, int, int]]] = {}
    for (cid, fragment, read_end, rev_comp) in candidate_rows:
        seq = read_lookup(int(fragment), int(read_end))
        if not seq:
            continue
        if rev_comp:
            seq = revcomp(seq)
        by_cluster.setdefault(int(cid), []).append(
            (seq, 0 if rev_comp else 1, 1 if rev_comp else 0))

    out: dict[int, tuple[str, int, int]] = {}
    for cid in sorted(by_cluster):
        entries = by_cluster[cid]
        seqs = [e[0] for e in entries]
        lflags = [e[1] for e in entries]
        rflags = [e[2] for e in entries]
        finder = PathFinder(k=k, max_length=max_length, find_all=False,
                            min_count=min_count)
        if finder.find_path(seqs, lflags, rflags) and finder.sequences:
            out[cid] = (finder.sequences[0], len(seqs),
                        finder.min_counts[0])
    return out


def infer_junction(task, assembly: str, k: int = 21):
    """Locate the assembly's junction against the task's flank pair.

    The assembly is in fusion orientation (flank1 -> flank2).  The
    junction is the end of the maximal exactly-matching prefix against
    flank1; the backwards match against flank2 must cover the rest of
    the assembly (sequencing errors or an unassembled middle yield
    None — no break position, so splitr wins arbitration by default).

    Returns (split1, split2) in the ``SplitAlignmentTask.evaluate``
    best_split convention: split1 = number of flank1 chars before the
    junction, split2 = index in flank2 of the last char *excluded*.
    """
    f1, f2 = task.split_align_seq
    n = len(assembly)
    if n < 2 * k:
        return None
    a = f1.find(assembly[:k])
    if a < 0:
        return None
    m = k
    while a + m < len(f1) and m < n and f1[a + m] == assembly[m]:
        m += 1
    e = f2.rfind(assembly[-k:])
    if e < 0:
        return None
    e += k - 1  # index in f2 of the assembly's last char
    t = k
    while e - t >= 0 and t < n \
            and f2[e - t] == assembly[n - 1 - t]:
        t += 1
    if m + t < n:  # prefix + suffix must cover the whole assembly
        return None
    # junction at the end of the maximal flank1 prefix; assembly chars
    # m..n-1 then map to f2 positions (e - (n - 1 - i)), so the last
    # excluded flank2 index is e - n + m
    split1 = a + m
    split2 = e - n + m
    if split2 < -1 or split2 >= len(f2):
        return None
    return split1, split2


def denovo_break_positions(task, split1: int, split2: int):
    """Convert flank splits to reference breakpoints — the exact
    coordinate rules of ``SplitAlignmentTask.evaluate``
    (``SplitAlignment.cpp:553-569``)."""
    if task.split_seq_strand[0] == 0:
        bp0 = task.split_align_seq_start[0] + split1 - 1
    else:
        bp0 = task.split_align_seq_start[0] \
            + task.split_align_seq_length[0] - split1
    if task.split_seq_strand[1] == 0:
        bp1 = task.split_align_seq_start[1] + split2 + 1
    else:
        bp1 = task.split_align_seq_start[1] \
            + task.split_align_seq_length[1] - split2 - 2
    return {0: bp0, 1: bp1}


def write_denovo_outputs(assemblies, splitr_span_pval, denovo_span_pval,
                         outdir):
    """``denovo.seq`` rows + ``denovo.span.pval`` + ``denovo.predict``.

    denovo.seq: cluster_id, sequence, n_reads, min_kmer_count.
    denovo.span.pval: cluster_id, span_count, pvalue (pvalue in field 2,
    where ``select_breakpoint_seq.pl:read_span_pval`` reads it).
    denovo.predict: per-cluster arbitration verdict.
    """
    import pathlib

    out = pathlib.Path(outdir)
    verdict = arbitrate(
        {cid: float(p) for cid, p in splitr_span_pval.items()},
        {cid: p for cid, (p, _n) in denovo_span_pval.items()})
    with open(out / "denovo.seq", "w") as fh:
        for cid in sorted(assemblies):
            seq, n_reads, min_count = assemblies[cid]
            fh.write(f"{cid}\t{seq}\t{n_reads}\t{min_count}\n")
    with open(out / "denovo.span.pval", "w") as fh:
        for cid in sorted(denovo_span_pval):
            p, n = denovo_span_pval[cid]
            fh.write(f"{cid}\t{n}\t{p:.15g}\n")
    with open(out / "denovo.predict", "w") as fh:
        for cid in sorted(verdict):
            fh.write(f"{cid}\t{verdict[cid]}\n")
    return verdict, {"denovo_seq": str(out / "denovo.seq"),
                     "denovo_span_pval": str(out / "denovo.span.pval"),
                     "denovo_predict": str(out / "denovo.predict")}


def denovo_annotation_rows(cluster_ids, assemblies, denovo_span_pval,
                           verdict):
    """The four documented denovo columns (``README.md:276-287``) as
    per-cluster annotation key/value pairs; every cluster gets all four
    keys (empty where no assembly) so the results.tsv columns are stable
    whenever denovo_assembly=yes."""
    rows: dict[int, dict[str, str]] = {}
    for cid in cluster_ids:
        a = rows.setdefault(int(cid), {})
        a["break_predict"] = verdict.get(cid, "splitr")
        seq, _n, min_count = assemblies.get(cid, ("", 0, 0))
        a["denovo_sequence"] = seq
        a["denovo_min_count"] = str(min_count) if cid in assemblies else ""
        a["denovo_span_pvalue"] = (f"{denovo_span_pval[cid][0]:.15g}"
                                   if cid in denovo_span_pval else "")
    return rows
