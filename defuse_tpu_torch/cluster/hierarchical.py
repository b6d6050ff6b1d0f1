"""Average-linkage agglomerative clustering — the legacy
``tools/HierarchicalClusterer.cpp`` alternative clusterer (not linked by
any 0.8 binary but part of the reference's clustering surface).

Merges the closest cluster pair until the minimum distance reaches the
threshold; merged distances are size-weighted averages
(``HierarchicalClusterer.cpp:46-140``).  Ties break on the smaller
sorted index pair (canonical; the reference's boost-bimap tie order is
an internal artifact).
"""

from __future__ import annotations

import heapq


def hierarchical_cluster(distances, threshold: float):
    """distances: square matrix (list of lists); returns clusters as
    lists of original indices, in surviving-cluster creation order."""
    n = len(distances)
    if n < 1:
        return []
    clusters: dict[int, list[int]] = {i: [i] for i in range(n)}
    dist: dict[tuple[int, int], float] = {}
    heap: list[tuple[float, int, int]] = []
    for i in range(n):
        for j in range(i + 1, n):
            dist[(i, j)] = distances[i][j]
            heapq.heappush(heap, (distances[i][j], i, j))
    next_index = n

    while heap:
        d, i, j = heap[0]
        if (i, j) not in dist or dist[(i, j)] != d:
            heapq.heappop(heap)
            continue
        if d >= threshold:
            break
        heapq.heappop(heap)
        del dist[(i, j)]
        size_i = len(clusters[i])
        size_j = len(clusters[j])
        merged = clusters[i] + clusters[j]
        mi = next_index
        next_index += 1
        others = [c for c in clusters if c not in (i, j)]
        del clusters[i]
        del clusters[j]
        for c in others:
            key_i = (min(i, c), max(i, c))
            key_j = (min(j, c), max(j, c))
            d_i = dist.pop(key_i)
            d_j = dist.pop(key_j)
            d_m = (size_i * d_i + size_j * d_j) / (size_i + size_j)
            key_m = (min(mi, c), max(mi, c))
            dist[key_m] = d_m
            heapq.heappush(heap, (d_m, key_m[0], key_m[1]))
        clusters[mi] = merged

    return [clusters[c] for c in sorted(clusters)]
