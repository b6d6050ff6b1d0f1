"""SAM / compact alignment parsing into struct-of-arrays tables.

Mirrors the semantics of the reference's streaming parsers
(``tools/AlignmentStream.cpp``): SAM rows with ``*`` reference are skipped,
strand comes from flag bit 0x10, the read end comes from a ``/1``/``/2``
qname suffix (else flags 0x40/0x80), and the alignment end is
``pos + len(seq) - 1`` (the reference ignores CIGAR for this purpose,
``AlignmentStream.cpp:122-123``).
"""

from __future__ import annotations

import dataclasses

import numpy as np

from ..core.types import AlignmentTable, NameIndex


def open_text(path):
    """Text handle over a possibly-gzipped file, sniffed by magic bytes
    (large intermediates like ``cdna.pair.sam.gz`` are written as
    concatenated gzip members; readers never trust the extension)."""
    import gzip
    with open(path, "rb") as probe:
        magic = probe.read(2)
    if magic == b"\x1f\x8b":
        return gzip.open(path, "rt")
    return open(path)


def read_decompressed(path) -> bytes:
    """Whole-file bytes after transparent gzip decompression (the
    byte-parity contract for compressed artifacts is on the content)."""
    with open_text(path) as fh:
        return fh.read().encode()


@dataclasses.dataclass
class SamRecord:
    fragment: str
    read_end: int
    reference: str
    strand: int
    start: int
    end: int
    sequence: str


def iter_sam(path):
    """Yield SamRecord per aligned SAM row (``AlignmentStream.cpp:39-130``)."""
    with open_text(path) as fh:
        for line in fh:
            if line.startswith("@"):
                continue
            fields = line.rstrip("\n").split("\t")
            if len(fields) < 10:
                raise ValueError(f"SAM format error: {line!r}")
            qname, flag, rname, pos, seq = (
                fields[0], int(fields[1]), fields[2], int(fields[3]), fields[9])
            if rname == "*":
                continue
            strand = 1 if (flag & 0x10) else 0
            if "/" in qname:
                fragment, endstr = qname.rsplit("/", 1)
                if endstr not in ("1", "2"):
                    raise ValueError(f"bad qname {qname!r}")
                read_end = 0 if endstr == "1" else 1
            else:
                fragment = qname
                read_end = 0 if (flag & 0x40) else 1
            yield SamRecord(fragment, read_end, rname, strand, pos,
                            pos + len(seq) - 1, seq)


def iter_compact(path):
    """Yield rows of the compact alignment format: fragment, readEnd,
    ref, strand(+/-), start, end (``AlignmentStream.cpp:156-189``).

    Quirk preserved from the reference: ``divide_sam_chr_pairs.pl`` writes
    the 0-based SAM read end into field 1, but the C++ parser maps
    ``"1" -> 0, else -> 1`` — so read ends arrive *flipped* in the
    clusterer.  We reproduce that exactly (it is symmetric and affects
    only the readEnd output column).
    """
    with open(path) as fh:
        for line in fh:
            fields = line.rstrip("\n").split("\t")
            if len(fields) < 6:
                raise ValueError(f"compact format error: {line!r}")
            yield SamRecord(
                fragment=fields[0],
                read_end=0 if fields[1] == "1" else 1,
                reference=fields[2],
                strand=1 if fields[3] == "-" else 0,
                start=int(fields[4]),
                end=int(fields[5]),
                sequence="",
            )


def load_alignments(records, fragment_ids_are_ints: bool = True):
    """Materialize an AlignmentTable from an iterable of SamRecord.

    References are interned in first-appearance order (matching the
    reference's ``NameIndex``, ``clustermatepairs.cpp:443``).  Fragment
    names must already be integers when ``fragment_ids_are_ints`` (the
    pipeline renames fragments to integer ids up front, like
    ``scripts/index_paired_fastq.pl``); otherwise they are interned.
    """
    ref_index = NameIndex()
    frag_index = None if fragment_ids_are_ints else NameIndex()
    fragment, read_end, ref, strand, start, end = [], [], [], [], [], []
    for rec in records:
        if fragment_ids_are_ints:
            fragment.append(int(rec.fragment))
        else:
            fragment.append(frag_index.index(rec.fragment))
        read_end.append(rec.read_end)
        ref.append(ref_index.index(rec.reference))
        strand.append(rec.strand)
        start.append(rec.start)
        end.append(rec.end)
    return AlignmentTable(
        fragment=np.asarray(fragment, dtype=np.int32),
        read_end=np.asarray(read_end, dtype=np.int8),
        ref=np.asarray(ref, dtype=np.int32),
        strand=np.asarray(strand, dtype=np.int8),
        start=np.asarray(start, dtype=np.int32),
        end=np.asarray(end, dtype=np.int32),
        ref_names=ref_index.names,
    )
