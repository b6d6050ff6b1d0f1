"""Minimal BAM reader + BAM->paired-fastq conversion — the ``bamfastq``
equivalent (``tools/bamfastq.cpp``), dependency-free (BGZF via gzip's
multi-member support).

Semantics preserved: reverse-strand records are reverse-complemented back
to original read orientation; mates pair up via a name buffer in stream
order; ``rename`` numbers fragments by pairing order; ``multiples`` keeps
the first record per (name, end); failed-QC pairs are dropped; the '+'
line carries the original read name.
"""

from __future__ import annotations

import gzip
import struct

from ..core.types import revcomp

_SEQ_CODES = "=ACMGRSVTWYHKDBN"
_CIGAR_OPS = "MIDNSHP=X"


def read_bam(path):
    """Yield (name, flag, ref_id, pos, seq, qual) per alignment record."""
    with gzip.open(path, "rb") as fh:
        magic = fh.read(4)
        if magic != b"BAM\x01":
            raise ValueError("not a BAM file")
        l_text = struct.unpack("<i", fh.read(4))[0]
        fh.read(l_text)
        n_ref = struct.unpack("<i", fh.read(4))[0]
        refs = []
        for _ in range(n_ref):
            l_name = struct.unpack("<i", fh.read(4))[0]
            name = fh.read(l_name)[:-1].decode()
            l_ref = struct.unpack("<i", fh.read(4))[0]
            refs.append((name, l_ref))
        while True:
            raw = fh.read(4)
            if len(raw) < 4:
                break
            block_size = struct.unpack("<i", raw)[0]
            data = fh.read(block_size)
            (ref_id, pos, l_read_name, _mapq, _bin, n_cigar, flag,
             l_seq, _next_ref, _next_pos, _tlen) = struct.unpack(
                "<iiBBHHHiiii", data[:32])
            off = 32
            name = data[off:off + l_read_name - 1].decode()
            off += l_read_name
            off += 4 * n_cigar
            seq_bytes = data[off:off + (l_seq + 1) // 2]
            off += (l_seq + 1) // 2
            qual = data[off:off + l_seq]
            seq = "".join(
                _SEQ_CODES[(b >> 4) if i % 2 == 0 else (b & 0xF)]
                for i in range(l_seq)
                for b in [seq_bytes[i // 2]])
            qual_str = "".join(chr(q + 33) for q in qual) \
                if l_seq and qual[0] != 0xFF else "*"
            yield name, flag, ref_id, pos, seq, qual_str


def bam_to_fastq(bam_path, fastq1_path, fastq2_path, *, rename=False,
                 multiples=False, paired_names=False):
    """``bamfastq`` main loop (``bamfastq.cpp:62-199``)."""
    buffers: list[dict] = [{}, {}]
    seen_names: set[str] = set()
    fragment_index = 0
    with open(fastq1_path, "w") as f1, open(fastq2_path, "w") as f2:
        outs = [f1, f2]
        for name, flag, _ref, _pos, seq, qual in read_bam(bam_path):
            read_end = 0 if flag & 0x40 else 1
            if paired_names:
                if len(name) < 2 or name[-2] != "/" or \
                        name[-1] not in "12":
                    raise ValueError(f"bad paired name {name}")
                read_end = 0 if name[-1] == "1" else 1
                name = name[:-2]
            if multiples:
                if name in seen_names or name in buffers[read_end]:
                    continue
            if flag & 0x10:
                seq = revcomp(seq)
                qual = qual[::-1]
            other = 1 - read_end
            failed_qc = bool(flag & 0x200)
            if name in buffers[other]:
                o_seq, o_qual, o_failed = buffers[other].pop(name)
                if not failed_qc and not o_failed:
                    fragment = str(fragment_index) if rename else name
                    outs[read_end].write(
                        f"@{fragment}/{read_end + 1}\n{seq}\n+{name}\n"
                        f"{qual}\n")
                    outs[other].write(
                        f"@{fragment}/{other + 1}\n{o_seq}\n+{name}\n"
                        f"{o_qual}\n")
                    if multiples:
                        seen_names.add(name)
                    fragment_index += 1
            else:
                buffers[read_end][name] = (seq, qual, failed_qc)
    return fragment_index
