"""Transcript exon tables and transcript<->genome coordinate remapping.

Replaces ``tools/ExonRegions.{h,cpp}``.  File format: per line
``gene<TAB>transcript<TAB>chromosome<TAB>strand<TAB>start1<TAB>end1[...]``
(pairs of exon start/end, 1-based inclusive, ascending genomic order).

Remapping semantics match the reference exactly, including the
out-of-transcript extrapolation in ``RemapTranscriptToGenome``
(``ExonRegions.cpp:258-302``) and the strand-space walk in
``RemapThroughTranscript`` (``ExonRegions.cpp:421-482``).

Transcript lookup by region returns transcripts in sorted name order
(canonical; the golden build's ordered shims match).
"""

from __future__ import annotations

import dataclasses

BIN_LENGTH = 100000


@dataclasses.dataclass
class _Transcript:
    gene: str
    chromosome: str
    strand: int  # genomic strand of the transcript
    exons: list[tuple[int, int]]  # ascending genomic order
    length: int
    region: tuple[int, int]


class ExonRegions:
    def __init__(self) -> None:
        self._transcripts: dict[str, _Transcript] = {}
        self._gene_transcripts: dict[str, list[str]] = {}
        self._lookup: dict[str, dict[int, list[str]]] = {}

    @classmethod
    def from_file(cls, path: str) -> "ExonRegions":
        er = cls()
        with open(path) as fh:
            for line in fh:
                line = line.rstrip("\n")
                if not line:
                    continue
                fields = line.split("\t")
                if len(fields) < 6:
                    continue
                gene, transcript, chromosome, strand = fields[:4]
                exons = []
                for i in range(5, len(fields), 2):
                    exons.append((int(fields[i - 1]), int(fields[i])))
                er.add(gene, transcript, chromosome,
                       0 if strand == "+" else 1, exons)
        return er

    def add(self, gene, transcript, chromosome, strand, exons) -> None:
        length = sum(e - s + 1 for s, e in exons)
        t = _Transcript(gene, chromosome, strand, list(exons), length,
                        (exons[0][0], exons[-1][1]))
        self._transcripts[transcript] = t
        self._gene_transcripts.setdefault(gene, []).append(transcript)
        lookup = self._lookup.setdefault(chromosome, {})
        for b in range(t.region[0] // BIN_LENGTH, t.region[1] // BIN_LENGTH + 1):
            lookup.setdefault(b, []).append(transcript)

    # -- queries ---------------------------------------------------------

    def is_transcript(self, transcript: str) -> bool:
        return transcript in self._transcripts

    def transcript_gene(self, transcript: str) -> str:
        return self._transcripts[transcript].gene

    def gene_transcripts(self, gene: str) -> list[str]:
        return self._gene_transcripts[gene]

    def transcript_length(self, transcript: str) -> int:
        return self._transcripts[transcript].length

    def region_transcripts(self, chromosome: str, start: int,
                           end: int) -> list[str]:
        """Transcripts overlapping [start, end], sorted by name
        (``ExonRegions.cpp:131-161``)."""
        lookup = self._lookup.get(chromosome)
        if lookup is None:
            raise KeyError(f"invalid chromosome {chromosome}")
        found = set()
        for b in range(start // BIN_LENGTH, end // BIN_LENGTH + 1):
            for name in lookup.get(b, ()):
                r = self._transcripts[name].region
                if not (r[1] < start or r[0] > end):
                    found.add(name)
        return sorted(found)

    # -- remapping -------------------------------------------------------

    def remap_transcript_to_genome(self, transcript: str, strand: int,
                                   position: int):
        """(chromosome, strand, genome position) for a transcript-space
        position (``ExonRegions.cpp:258-302``)."""
        t = self._transcripts[transcript]
        remap_strand = 0 if t.strand == strand else 1
        if t.strand == 1:
            position = t.length - position + 1
        local_offset = 0
        for es, ee in t.exons:
            exon_len = ee - es + 1
            local_end = local_offset + exon_len
            if position <= local_end:
                return t.chromosome, remap_strand, \
                    position - (local_offset + 1) + es
            local_offset += exon_len
        return t.chromosome, remap_strand, \
            position - t.length + t.exons[-1][1]

    def remap_genome_to_transcript(self, transcript: str, position: int):
        """Transcript-space position or None (``ExonRegions.cpp:304-338``)."""
        t = self._transcripts[transcript]
        local_offset = 0
        for es, ee in t.exons:
            if es <= position <= ee:
                remapped = position - es + local_offset + 1
                if t.strand == 1:
                    remapped = t.length - remapped + 1
                return remapped
            local_offset += ee - es + 1
        return None

    def remap_through_transcript(self, transcript: str, position: int,
                                 strand: int, extend_min: int,
                                 extend_max: int):
        """Project a genomic position through a transcript and extend by
        [extend_min, extend_max] along ``strand``
        (``ExonRegions.cpp:421-482``).

        Returns (remap_strand, start, end) or None.
        """
        t = self._transcripts[transcript]
        remap_strand = 0 if strand == t.strand else 1

        # exons in strand space
        if strand == 0:
            exons = t.exons
            strand_position = position
        else:
            exons = [(-e, -s) for s, e in reversed(t.exons)]
            strand_position = -position

        if strand_position > exons[-1][1]:
            return None

        start = end = None
        local_offset = 0
        for es, ee in exons:
            exon_len = ee - es + 1
            if strand_position <= ee:
                rel_start = strand_position - es + extend_min + 1
                rel_end = strand_position - es + extend_max + 1
                if rel_end < 1:
                    return None
                start = max(1, rel_start) + local_offset
                end = max(1, rel_end) + local_offset
                break
            local_offset += exon_len

        if end is None or end < 1 or start > t.length:
            return None

        if strand != t.strand:
            start, end = t.length - end + 1, t.length - start + 1
        return remap_strand, start, end
