"""Greedy set-cover assignment of fragments to clusters.

Maximum-parsimony fragment assignment (``tools/setcover.cpp:30-110``): pick
the cluster with the most unassigned fragments, assign its fragments,
decrement every other cluster containing them; repeat.  Size ties break to
the lowest cluster ID (canonical; see DESIGN.md).  Inherently sequential
and cheap — runs host-side, like the reference (32 GB host job,
``defuse_run.pl:473-477``).

Input/output mirror the reference: clusters are read from cluster rows
(end 0 only, ``tools/Parsers.cpp:61-65``), the solution rewrites the full
row file keeping only (cluster, fragment) pairs in the cover and dropping
clusters below ``min_cluster_size`` (``tools/Parsers.cpp:86-120``).
"""

from __future__ import annotations

import heapq


def set_cover(clusters: list[list[int]]) -> list[list[int]]:
    """Greedy set cover; returns per-cluster kept fragment lists."""
    solution: list[list[int]] = [[] for _ in clusters]
    sizes = [len(c) for c in clusters]

    element_clusters: dict[int, list[int]] = {}
    for ci, cluster in enumerate(clusters):
        for e in cluster:
            element_clusters.setdefault(e, []).append(ci)

    assigned: set[int] = set()
    # lazy max-heap keyed (-size, cluster_index): ties -> lowest id
    heap = [(-sizes[ci], ci) for ci in range(len(clusters))]
    heapq.heapify(heap)

    while heap:
        neg_size, ci = heapq.heappop(heap)
        if -neg_size != sizes[ci]:
            continue  # stale entry
        if sizes[ci] == 0:
            break
        for e in clusters[ci]:
            if e in assigned:
                continue
            assigned.add(e)
            solution[ci].append(e)
            # decrement every cluster containing e (including ci, whose
            # remaining size reaches 0 by the end of this pass)
            for other in element_clusters[e]:
                sizes[other] -= 1
                if other != ci:
                    heapq.heappush(heap, (-sizes[other], other))

    return solution


def read_cluster_fragments(path: str) -> list[list[int]]:
    """Read end-0 fragment lists per cluster ID (``Parsers.cpp:23-84``)."""
    clusters: list[list[int]] = []
    with open(path) as fh:
        for line in fh:
            fields = line.rstrip("\n").split("\t")
            cluster_id = int(fields[0])
            cluster_end = int(fields[1])
            fragment = int(fields[2])
            if cluster_end != 0:
                continue
            while len(clusters) <= cluster_id:
                clusters.append([])
            clusters[cluster_id].append(fragment)
    return clusters


def rewrite_clusters(in_path: str, out_path: str,
                     solution: list[list[int]], min_cluster_size: int) -> None:
    """Filter the full cluster-row file by the cover
    (``Parsers.cpp:86-170``)."""
    keep = [set(frags) if len(frags) >= min_cluster_size else set()
            for frags in solution]
    with open(in_path) as fh, open(out_path, "w") as out:
        for line in fh:
            fields = line.rstrip("\n").split("\t")
            cluster_id = int(fields[0])
            fragment = int(fields[2])
            if cluster_id < len(keep) and fragment in keep[cluster_id]:
                out.write(line)


def run_setcover_file(in_path: str, out_path: str,
                      min_cluster_size: int) -> None:
    from . import native
    if native.available():
        # whole stage in C++ (parse + solve + rewrite, byte-identical)
        if native.setcover_file(in_path, out_path,
                                min_cluster_size) is not None:
            return
    clusters = read_cluster_fragments(in_path)
    if native.available():
        solution = native.set_cover(clusters)
    else:
        solution = set_cover(clusters)
    rewrite_clusters(in_path, out_path, solution, min_cluster_size)
