"""De novo breakpoint assembly — the ``tools/PathFinder.cpp`` equivalent.

De Bruijn k-mer path search between the highest-count "left" and "right"
anchor k-mers: builds the k-mer graph from candidate reads, then a DFS
with min-count pruning emits fusion-sequence candidates
(``PathFinder.cpp:75-247``).  The reference's 0.8 pipeline keeps this in
the output schema (``denovo_*`` columns) without invoking it; we expose
it for the denovo discovery path.

DFS order replicated: edges sorted ascending by target k-mer count
(stable over A,C,T,G enumeration), explored via an explicit LIFO stack.
"""

from __future__ import annotations

NUCLEOTIDES = "ACTG"  # reference enumeration order (PathFinder.cpp:45-54)


class PathFinder:
    def __init__(self, k: int, max_length: int, find_all: bool,
                 min_count: int):
        self.k = k
        self.max_length = max_length
        self.find_all = find_all
        self.min_count = min_count
        self.sequences: list[str] = []
        self.min_counts: list[int] = []

    def find_path(self, sequences, left_flags, right_flags) -> bool:
        k = self.k
        self.sequences = []
        self.min_counts = []

        counts: dict[str, int] = {}
        left_counts: dict[str, int] = {}
        right_counts: dict[str, int] = {}
        order: list[str] = []
        for seq, left, right in zip(sequences, left_flags, right_flags):
            if len(seq) < k:
                continue
            for start in range(len(seq) - k + 1):
                kmer = seq[start:start + k]
                if kmer not in counts:
                    counts[kmer] = 0
                    left_counts[kmer] = 0
                    right_counts[kmer] = 0
                    order.append(kmer)
                counts[kmer] += 1
                if left:
                    left_counts[kmer] += 1
                if right:
                    right_counts[kmer] += 1

        edges: dict[str, list[tuple[int, str, str]]] = {}
        for kmer in order:
            exts = []
            for nt in NUCLEOTIDES:
                ext = kmer[1:] + nt
                if ext in counts:
                    exts.append((counts[ext], nt, ext))
            exts.sort(key=lambda e: e[0])  # ascending count, stable
            edges[kmer] = exts

        start_kmer = None
        start_max = 0
        end_kmer = None
        end_max = 0
        for kmer in order:
            if left_counts[kmer] > start_max:
                start_max = left_counts[kmer]
                start_kmer = kmer
            if right_counts[kmer] > end_max:
                end_max = right_counts[kmer]
                end_kmer = kmer
        if start_kmer is None or end_kmer is None:
            return False

        visited = {start_kmer}
        stack = [(start_kmer, start_kmer, counts[start_kmer])]
        while stack:
            seq, kmer, min_count = stack.pop()
            for count, nt, ext in edges[kmer]:
                next_seq = seq + nt
                next_min = min(min_count, count)
                if next_min < self.min_count:
                    continue
                if ext == end_kmer:
                    self.sequences.append(next_seq)
                    self.min_counts.append(next_min)
                    if not self.find_all:
                        return True
                elif len(next_seq) <= self.max_length and ext not in visited:
                    stack.append((next_seq, ext, next_min))
                    visited.add(ext)
        return bool(self.sequences)
