"""FASTA store with faidx-compatible indexed access.

Replaces the reference's samtools-faidx wrapper (``tools/FastaIndex.cpp``)
with an in-process store.  ``get`` reproduces the exact clamping semantics
of ``FastaIndex::Get`` + ``fai_fetch`` (samtools-0.1.8 ``faidx.c:305-343``):

* length < 0  -> empty sequence
* start < 1   -> length reduced by (1 - start), start clamped to 1
* end clamped to the sequence length
* minus strand -> reverse complement of the fetched slice

``get`` returns the (possibly clamped) start and actual fetched length —
callers store these, and downstream breakpoint arithmetic depends on them
(``SplitAlignment.cpp:79`` stores the by-reference-updated values).
"""

from __future__ import annotations

from ..core.types import revcomp


class FastaStore:
    def __init__(self, sequences: dict[str, str]):
        self._seqs = sequences

    @classmethod
    def from_file(cls, path: str) -> "FastaStore":
        # bulk-string parse: one read, header scan by "\n>", newline
        # strip via str.replace (C speed) — the per-line Python loop was
        # the single largest Python cost of a discover pass (~80ms on
        # the bench genome, 76k line-method calls)
        with open(path) as fh:
            data = fh.read()
        seqs: dict[str, str] = {}
        pos = data.find(">")
        while pos != -1:
            nl = data.find("\n", pos)
            if nl == -1:
                break
            name = data[pos + 1:nl].split()[0]
            nxt = data.find("\n>", nl)
            end = len(data) if nxt == -1 else nxt + 1
            seqs[name] = data[nl + 1:end].replace("\n", "")
            pos = -1 if nxt == -1 else nxt + 1
        return cls(seqs)

    def __contains__(self, name: str) -> bool:
        return name in self._seqs

    def sequence(self, name: str) -> str:
        return self._seqs[name]

    def get(self, name: str, strand: int, start: int, length: int):
        """Fetch with reference-identical clamping.

        Returns (sequence, clamped_start, fetched_length).
        """
        if length < 0:
            return "", start, length
        if start < 1:
            length -= 1 - start
            start = 1
        seq = self._seqs[name]
        beg = start - 1
        end = start + length - 1  # 1-based inclusive == 0-based exclusive
        if beg >= len(seq):
            beg = len(seq)
        if end >= len(seq):
            end = len(seq)
        if end < beg:
            end = beg
        fetched = seq[beg:end]
        if strand == 1:
            fetched = revcomp(fetched)
        return fetched, start, len(fetched)


def write_fasta(path: str, sequences: dict[str, str], width: int = 60) -> None:
    """Write a FASTA file plus a samtools-compatible .fai index."""
    with open(path, "w") as out:
        fai_rows = []
        offset = 0
        for name, seq in sequences.items():
            header = f">{name}\n"
            out.write(header)
            offset += len(header)
            fai_rows.append((name, len(seq), offset, width, width + 1))
            for i in range(0, len(seq), width):
                line = seq[i:i + width] + "\n"
                out.write(line)
                offset += len(line)
    with open(path + ".fai", "w") as fai:
        for name, length, off, bases, bwidth in fai_rows:
            fai.write(f"{name}\t{length}\t{off}\t{bases}\t{bwidth}\n")
