"""Systematic debug-check layer — the ``-DDEBUG_CHECKS`` equivalent.

The reference compiles ``DebugCheck.h`` asserts in with
``-DDEBUG_CHECKS`` (``tools/makefile:23``); here the same contract is an
env switch (``DEFUSE_DEBUG_CHECKS=1``) gating invariant checks at stage
boundaries.  Checks are free when disabled (callers guard with
``enabled()``) and raise ``DebugCheckError`` with the violated invariant
when enabled — a failed check means a bug, never bad user input.
"""

from __future__ import annotations

import os


class DebugCheckError(AssertionError):
    pass


def enabled() -> bool:
    return bool(os.environ.get("DEFUSE_DEBUG_CHECKS"))


def check(condition: bool, message: str) -> None:
    if not condition:
        raise DebugCheckError(message)


def check_clusters_file(path: str, min_cluster_size: int) -> None:
    """Cluster rows: schema, per-cluster both ends present, sizes >=
    threshold, fragment uniqueness within an end
    (``clustermatepairs.cpp:549-583`` postconditions)."""
    if not enabled():
        return
    clusters: dict[str, dict[int, set]] = {}
    with open(path) as fh:
        for ln, line in enumerate(fh, 1):
            f = line.rstrip("\n").split("\t")
            check(len(f) == 8, f"clusters row {ln}: {len(f)} fields")
            cid, end, frag = f[0], int(f[1]), f[2]
            check(end in (0, 1), f"clusters row {ln}: end {end}")
            check(f[3] in ("0", "1"), f"clusters row {ln}: read end")
            check(int(f[6]) <= int(f[7]),
                  f"clusters row {ln}: start > end")
            ends = clusters.setdefault(cid, {0: set(), 1: set()})
            check(frag not in ends[end],
                  f"cluster {cid}: duplicate fragment {frag} end {end}")
            ends[end].add(frag)
    for cid, ends in clusters.items():
        check(bool(ends[0]) and bool(ends[1]),
              f"cluster {cid}: missing an end")
        check(len(ends[0]) == len(ends[1]),
              f"cluster {cid}: end size mismatch")
        check(len(ends[0]) >= min_cluster_size,
              f"cluster {cid}: below min size")


def check_setcover_file(clusters_path: str, sc_path: str) -> None:
    """Set-cover postcondition: surviving rows are a subset of the input
    and every surviving fragment is assigned to exactly one cluster
    (``setcover.cpp:30-110`` contract)."""
    if not enabled():
        return

    def load(path):
        rows = set()
        frag_cluster: dict[str, set] = {}
        with open(path) as fh:
            for line in fh:
                f = line.rstrip("\n").split("\t")
                rows.add(tuple(f))
                if f[1] == "0":
                    frag_cluster.setdefault(f[2], set()).add(f[0])
        return rows, frag_cluster

    in_rows, _ = load(clusters_path)
    out_rows, out_frags = load(sc_path)
    for row in out_rows:
        check(row in in_rows, f"setcover invented row {row}")
    for frag, cids in out_frags.items():
        check(len(cids) == 1,
              f"fragment {frag} in {len(cids)} clusters after setcover")


def check_split_alignments_sorted(path: str) -> None:
    """splitreads.alignments.sorted must ascend by cluster id
    (the ``sort -n`` contract feeding evalsplitalign)."""
    if not enabled():
        return
    last = -1
    with open(path) as fh:
        for ln, line in enumerate(fh, 1):
            cid = int(line.split("\t", 1)[0])
            check(cid >= last, f"split alignments out of order at {ln}")
            last = cid


def check_spanning_file(path: str) -> None:
    """Spanning rows: schema + both ends present per fragment
    (``filter_unmatched.pl`` postcondition)."""
    if not enabled():
        return
    ends: dict[str, set] = {}
    with open(path) as fh:
        for ln, line in enumerate(fh, 1):
            f = line.rstrip("\n").split("\t")
            check(len(f) == 6, f"spanning row {ln}: {len(f)} fields")
            check(f[3] in ("+", "-"), f"spanning row {ln}: strand")
            check(int(f[4]) <= int(f[5]), f"spanning row {ln}: coords")
            ends.setdefault(f[0], set()).add(f[1])
    for frag, es in ends.items():
        check(es == {"0", "1"},
              f"spanning fragment {frag}: ends {sorted(es)}")
