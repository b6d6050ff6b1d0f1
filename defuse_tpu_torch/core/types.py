"""Core data model: struct-of-arrays alignment tables and helpers.

The reference carries per-alignment records as C++ structs
(``tools/Common.h:220-233``); we carry columns of numpy arrays so that
filtering/binning/clustering are vectorized and feed JAX directly.
Coordinates are 1-based inclusive like the reference (SAM convention).
"""

from __future__ import annotations

import dataclasses

import numpy as np

PLUS_STRAND = 0
MINUS_STRAND = 1


@dataclasses.dataclass
class AlignmentTable:
    """Struct-of-arrays of compact alignments (``tools/Common.h:220-225``).

    fragment:  int32 fragment index
    read_end:  int8 0/1
    ref:       int32 interned reference index (see ``ref_names``)
    strand:    int8 0 (+) / 1 (-)
    start/end: int32, 1-based inclusive
    """

    fragment: np.ndarray
    read_end: np.ndarray
    ref: np.ndarray
    strand: np.ndarray
    start: np.ndarray
    end: np.ndarray
    ref_names: list[str]

    def __len__(self) -> int:
        return len(self.fragment)

    def take(self, idx) -> "AlignmentTable":
        return AlignmentTable(
            fragment=self.fragment[idx],
            read_end=self.read_end[idx],
            ref=self.ref[idx],
            strand=self.strand[idx],
            start=self.start[idx],
            end=self.end[idx],
            ref_names=self.ref_names,
        )


class NameIndex:
    """String→int interning in first-appearance order (``tools/Indexer.h``)."""

    def __init__(self) -> None:
        self._index: dict[str, int] = {}
        self._names: list[str] = []

    def index(self, name: str) -> int:
        idx = self._index.get(name)
        if idx is None:
            idx = len(self._names)
            self._index[name] = idx
            self._names.append(name)
        return idx

    def index_many(self, names) -> np.ndarray:
        return np.fromiter((self.index(n) for n in names), dtype=np.int32,
                           count=len(names))

    @property
    def names(self) -> list[str]:
        return self._names

    def __len__(self) -> int:
        return len(self._names)


_COMP = bytes.maketrans(b"ACGTacgt", b"TGCAtgca")


def revcomp(seq: str) -> str:
    """Reverse complement, preserving case and non-ACGT characters
    (``tools/Common.cpp:32-54``)."""
    return seq.translate(_COMP)[::-1]
