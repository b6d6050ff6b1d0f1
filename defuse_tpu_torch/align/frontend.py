"""Alignment frontend — the ``alignjob.pl`` equivalent.

From renamed paired fastqs to the clustering inputs, using the
seed-and-extend aligner (``align/seedindex.py``) in place of bowtie:

1. paired concordant screens vs cdna and genome (proper-pair model:
   same reference, fwd/rev orientation, insert <= max_insert_size)
2. fragment-length stats / covariance samples / expression from the
   cdna proper pairs
3. trim to ``discord_read_trim``, drop concordant fragments
4. single-end all-alignments vs cdna and genome (-k/-m semantics)
5. concordance re-screens: unmappable (>max_paired_alignments genomic
   loci combos), same-gene, same-region (``find_unmappable.pl``,
   ``find_concordant_gene.pl``, ``find_concordant_region.pl``)
6. rRNA screen and IG-pair exclusion
7. improper alignment set (matched dna+cdna per fragment minus
   blacklists) and spanning rows (both-ends fragments)

Outputs use the same row schemata as the reference so the downstream
byte-parity chain is unaffected.

This is the port's own copy of ``defuse_tpu/align/frontend.py``: fastq
ingest and ``align_job`` with its native C++ driver and its Python path
are the same host code.  ``align_reads`` differs in its verify wiring: the
one device stage, candidate verification, runs as the CUDA kernel of
``ops/verify_cuda.py`` through ``ops.verify_batch.DeviceVerifier`` when it
is engaged.
"""

from __future__ import annotations

import dataclasses
import os
import typing
import pathlib
import time

import numpy as np

from ..annotate.gene_models import GeneModels
from ..cluster import native
from ..core.devices import require_cuda
from ..io.fasta import FastaStore
from ..ops.verify_batch import DeviceVerifier
from ..stats.readstats import ReadStats
from .seedindex import SeedIndex

UNMAPPABLE_BIN = 200000


class SingleAlignment(typing.NamedTuple):
    # NamedTuple: constructed in the millions on the frontend hot path
    ref_name: str
    strand: int
    start: int
    end: int
    mismatches: int


def index_paired_fastq(fastq1: str, fastq2: str, outdir: str):
    """Rename fragments to integer ids (``index_paired_fastq.pl``).
    Returns (reads1, reads2, names) lists indexed by fragment id."""
    out = pathlib.Path(outdir)
    out.mkdir(parents=True, exist_ok=True)
    names = []
    reads = ([], [])
    for end, path in ((0, fastq1), (1, fastq2)):
        with open(path) as fh:
            i = 0
            while True:
                header = fh.readline()
                if not header:
                    break
                seq = fh.readline().rstrip("\n")
                fh.readline()
                fh.readline()
                if end == 0:
                    names.append(header[1:].rstrip("\n").rsplit("/", 1)[0])
                reads[end].append(seq)
                i += 1
    with open(out / "reads.names", "w") as fh:
        for i, name in enumerate(names):
            fh.write(f"{i}\t{name}\n")
    for end in (0, 1):
        with open(out / f"reads.{end + 1}.fastq", "w") as fh:
            for i, seq in enumerate(reads[end]):
                fh.write(f"@{i}/{end + 1}\n{seq}\n+\n{'I' * len(seq)}\n")
    # O(1)-seek read index for the evidence viewer (ReadIndex.cpp format)
    from ..io.readindex import ReadIndex
    ReadIndex.build(str(out / "reads.1.fastq"),
                    str(out / "reads.2.fastq"), str(out / "reads.fqi"))
    return reads[0], reads[1], names


def _align_all(index: SeedIndex, reads, max_mismatch=2,
               max_alignments=None, verify_fn=None):
    """Per-read alignment lists as SingleAlignment (1-based, fwd coords).
    """
    if verify_fn is None and index.seed_len <= 16 and reads:
        from ..cluster import native
        if native.available():
            # native rows -> SingleAlignment directly (skips the
            # intermediate Alignment object layer)
            return _align_all_native(index, reads, max_mismatch,
                                     max_alignments)
    raw = index.align_batch(reads, max_mismatch=max_mismatch,
                            max_alignments=max_alignments,
                            verify_fn=verify_fn)
    out = []
    for read, hits in zip(reads, raw):
        if hits is None:
            out.append(None)
            continue
        row = []
        for a in hits:
            row.append(SingleAlignment(index.names[a.ref], a.strand,
                                       a.pos, a.pos + len(read) - 1,
                                       a.mismatches))
        out.append(row)
    return out


def _align_all_native(index, reads, max_mismatch, max_alignments):
    import numpy as np

    from ..cluster import native
    from .seedindex import encode

    B = len(reads)
    L = max(len(r) for r in reads)
    fwd = np.full((B, L), 4, dtype=np.uint8)
    lens = np.zeros(B, dtype=np.int32)
    for i, r in enumerate(reads):
        c = encode(r)
        fwd[i, :len(c)] = c.view(np.uint8)
        lens[i] = len(c)
    from .seedindex import _warn_short, seed_offsets
    k = index.seed_len
    seed_offs = seed_offsets(L, k)
    _warn_short(L, k)
    rows = native.align_batch(index, fwd, lens, seed_offs, 256,
                              max_mismatch)
    names = index.names
    lens_l = lens.tolist()
    out = [[] for _ in range(B)]
    for r, s, p, strand, m in rows.tolist():
        out[r].append(SingleAlignment(names[s], strand, p + 1,
                                      p + lens_l[r], m))
    if max_alignments is not None:
        for i in range(B):
            if len(out[i]) > max_alignments:
                out[i] = None
    return out


def _best_proper_pairs(aligns1, aligns2, max_insert: int):
    """Proper-pair screen: for each fragment, the best (fewest total
    mismatches, then leftmost) fwd/rev same-reference pair within the
    insert bound.  Returns {fragment: (a1, a2, isize)}."""
    pairs = {}
    for frag, (al1, al2) in enumerate(zip(aligns1, aligns2)):
        if not al1 or not al2:
            continue
        best = None
        for a1 in al1:
            for a2 in al2:
                if a1.ref_name != a2.ref_name or a1.strand == a2.strand:
                    continue
                fwd, rev = (a1, a2) if a1.strand == 0 else (a2, a1)
                if fwd.start > rev.start:
                    continue
                isize = rev.end - fwd.start + 1
                if isize > max_insert:
                    continue
                key = (a1.mismatches + a2.mismatches, fwd.start)
                if best is None or key < best[0]:
                    best = (key, a1, a2, isize)
        if best is not None:
            pairs[frag] = (best[1], best[2], best[3])
    return pairs


def write_pair_sam(pairs, reads1, reads2, path, frag_base=0,
                   append=False) -> None:
    """Proper-pair SAM rows (flags 0x2 pairing) for read stats / calccov
    / expression.  A ``.gz`` path gzips (level 1 — checkpoint artifact
    on a ~70MB/s filesystem, speed over ratio).  ``append`` adds to an
    existing file (a fresh gzip member on .gz — concatenated members
    are a valid stream)."""
    import contextlib
    import gzip
    if str(path).endswith(".gz"):
        ctx = gzip.open(path, "at" if append else "wt", compresslevel=1)
    else:
        ctx = open(path, "a" if append else "w")
    with contextlib.closing(ctx) as out:
        for frag in sorted(pairs):
            a1, a2, isize = pairs[frag]
            for end, (a, mate, seq) in enumerate(
                    ((a1, a2, reads1[frag]), (a2, a1, reads2[frag]))):
                flag = 0x1 | 0x2 | (0x40 if end == 0 else 0x80)
                if a.strand:
                    flag |= 0x10
                if mate.strand:
                    flag |= 0x20
                sign = 1 if a.start <= mate.start else -1
                # bowtie-style bare qname; the flags carry the read end
                out.write(f"{frag + frag_base}\t{flag}\t{a.ref_name}\t"
                          f"{a.start}\t255\t{len(seq)}M\t=\t{mate.start}\t"
                          f"{sign * isize}\t{seq}\t{'I' * len(seq)}\n")


def write_pair_tbl(pairs, reads1, reads2, names, path,
                   frag_base=0, append=False) -> None:
    """Binary proper-pair table twin of ``write_pair_sam`` (native
    ``PairRec`` layout: magic, n_pairs, name table, 32B records) —
    byte-identical to dt_align_job's ``cdna.pair.tbl``, letting read
    stats / calccov skip the SAM text re-parse.  ``append`` adds a new
    self-describing segment; readers stream all segments."""
    import numpy as np
    name_to_id = {n: i for i, n in enumerate(names)}
    blob = "".join(names).encode()
    off = np.zeros(len(names) + 1, dtype="<i8")
    for i, n in enumerate(names):
        off[i + 1] = off[i] + len(n.encode())
    rec_dt = np.dtype([("frag", "<i8"), ("seq", "<i4"), ("pos1", "<i4"),
                       ("len1", "<i4"), ("pos2", "<i4"), ("len2", "<i4"),
                       ("isize", "<i4")])
    recs = np.zeros(len(pairs), dtype=rec_dt)
    for i, frag in enumerate(sorted(pairs)):
        a1, a2, isize = pairs[frag]
        # seq high bit carries the end-1 strand so the SAM flag bits are
        # regenerable exactly (pos1 == pos2 leaves fwd/rev ambiguous)
        seq_id = np.int32(np.uint32(name_to_id[a1.ref_name])
                          | (np.uint32(a1.strand) << np.uint32(31)))
        recs[i] = (frag + frag_base, seq_id, a1.start,
                   len(reads1[frag]), a2.start, len(reads2[frag]), isize)
    with open(path, "ab" if append else "wb") as fh:
        fh.write(b"DPTBL2\n\x00")  # v2: strand bit packed in seq
        fh.write(np.int64(len(recs)).tobytes())
        fh.write(np.int64(len(names)).tobytes())
        fh.write(np.int64(off[-1]).tobytes())
        fh.write(off.tobytes())
        fh.write(blob)
        fh.write(recs.tobytes())


def pair_sam_from_tbl(tbl_path, reads_prefix, out_path) -> str:
    """Regenerate the proper-pair SAM text from the binary pair table
    plus the renamed fastqs (``reads_prefix`` as for ``ReadIndex``) —
    the lazy twin of ``write_pair_sam``.  Decompressed content is
    byte-identical to the eager writer's (pinned by
    tests/test_pair_tbl_lazy.py); fragment ids in the table are global,
    matching renamed-fastq record order, so the reads are streamed
    sequentially (no per-record seeks).  The output is written to a
    tmp file and renamed — a killed regeneration never leaves a
    truncated artifact at the final name."""
    import contextlib
    import gzip
    import os

    from ..parallel.shard import pair_table_has_strand, \
        read_pair_table, unpack_seq_strand
    if not pair_table_has_strand(tbl_path):
        raise ValueError(
            f"{tbl_path} is a v1 pair table (no packed strand bit); "
            "the SAM flags cannot be regenerated from it — rerun the "
            "frontend or use the eager pair SAM")
    from ..io.readindex import resolve_fastq_pair
    seq_paths, _backed, _fqi = resolve_fastq_pair(
        f"{reads_prefix}.1.fastq", f"{reads_prefix}.2.fastq")
    for path in seq_paths:
        if not os.path.exists(path):
            raise ValueError(
                "lazy pair-SAM regeneration needs the frontend's "
                f"read store at {reads_prefix}.<end>.fastq")
    names, recs = read_pair_table(tbl_path)
    seq_id, strand1 = unpack_seq_strand(recs)

    def seq_stream(end):
        """Yield read sequences for ascending table fragments from the
        renamed fastq (4-line records in fragment order)."""
        frags = recs["frag"].tolist()
        with open(seq_paths[end], "r", buffering=1 << 20) as fh:
            pos = -1
            for frag in frags:
                while pos < frag:
                    if not fh.readline():
                        raise ValueError("renamed fastq shorter than "
                                         "the pair table")
                    seq = fh.readline().rstrip("\n")
                    fh.readline()
                    fh.readline()
                    pos += 1
                yield seq

    tmp_path = f"{out_path}.tmp.gz" if str(out_path).endswith(".gz") \
        else f"{out_path}.tmp"
    if str(out_path).endswith(".gz"):
        ctx = gzip.open(tmp_path, "wt", compresslevel=1)
    else:
        ctx = open(tmp_path, "w")
    cols = (recs["frag"].tolist(), seq_id.tolist(), strand1.tolist(),
            recs["pos1"].tolist(), recs["pos2"].tolist(),
            recs["isize"].tolist())
    try:
        with contextlib.closing(ctx) as out:
            buf = []
            streams = (seq_stream(0), seq_stream(1))
            for frag, sid, s1, pos1, pos2, isize in zip(*cols):
                ref = names[sid]
                for end, (strand, pos, mpos) in enumerate(
                        ((s1, pos1, pos2), (1 - s1, pos2, pos1))):
                    flag = 0x1 | 0x2 | (0x40 if end == 0 else 0x80)
                    if strand:
                        flag |= 0x10
                    if strand == 0:  # mate reverse iff this end fwd
                        flag |= 0x20
                    seq = next(streams[end])
                    sign = 1 if pos <= mpos else -1
                    buf.append(
                        f"{frag}\t{flag}\t{ref}\t{pos}\t255\t"
                        f"{len(seq)}M\t=\t{mpos}\t{sign * isize}\t"
                        f"{seq}\t{'I' * len(seq)}\n")
                if len(buf) >= 65536:
                    out.write("".join(buf))
                    buf.clear()
            out.write("".join(buf))
    except BaseException:
        if os.path.exists(tmp_path):
            os.unlink(tmp_path)
        raise
    os.replace(tmp_path, out_path)
    return str(out_path)


def _genomic_loci_count(aligns, gene_models: GeneModels) -> int:
    """Distinct genomic loci for one read's alignments
    (``find_unmappable.pl`` overlap-group counting, canonical order)."""
    positions = []
    for a in aligns:
        chrom = gene_models.calc_genomic_chromosome(a.ref_name)
        s = gene_models.calc_genomic_position(a.ref_name, a.start)
        e = gene_models.calc_genomic_position(a.ref_name, a.end)
        if s > e:
            s, e = e, s
        positions.append((chrom, s, e))
    bins: dict = {}
    for i, (chrom, s, e) in enumerate(positions):
        for b in range(s // UNMAPPABLE_BIN, e // UNMAPPABLE_BIN + 1):
            bins.setdefault((chrom, b), []).append(i)
    overlapping: dict[int, set] = {}
    for members in bins.values():
        for i in members:
            for j in members:
                if not (positions[i][2] < positions[j][1]
                        or positions[i][1] > positions[j][2]):
                    overlapping.setdefault(i, set()).add(j)
    count = 0
    remaining = dict(sorted(overlapping.items()))
    while remaining:
        i = next(iter(remaining))
        for j in list(remaining[i]):
            remaining.pop(j, None)
        count += 1
    return count


def align_job(*, cdna_index: SeedIndex, genome_index: SeedIndex,
              rrna_index: SeedIndex | None, gene_models: GeneModels,
              reads1, reads2, outdir: str, max_insert_size: int = 500,
              discord_read_trim: int = 50, max_paired_alignments: int = 10,
              dna_concordant_length: int = 2000, max_alignments: int = 100,
              ig_genes: set[str] | None = None, verify_fn=None,
              prefilter_index: SeedIndex | None = None,
              force_python: bool = False, frag_base: int = 0,
              append: bool = False, write_sam: bool = True):
    """Run the full alignjob flow.  Returns paths dict.

    ``write_sam=False`` (native path only) skips the pair-SAM text
    checkpoint: the binary pair table carries everything the SAM does
    (incl. the end-1 strand bit), and ``pair_sam_from_tbl`` regenerates
    the text on demand.  The Python oracle path always writes the SAM —
    it is the byte contract the regeneration is pinned against.

    ``frag_base`` offsets every fragment id written to the artifact
    files (spanning/improper/pair sam/pair tbl) so data-parallel shards
    emit globally-correct ids and the shard merge degenerates to a raw
    byte append (``defuse_run.pl:387-400`` merge semantics).  The
    returned ``concordant_fragments``/``blacklist`` sets stay
    shard-local indices.

    ``append`` opens every artifact in append mode: sequential shards
    can write straight into the final files (shard 0 truncates with
    ``append=False``), removing the merge copy pass entirely — .gz
    artifacts gain one gzip member per shard, the pair table gains one
    self-describing segment per shard.

    The hot path is the native C++ driver (``dt_align_job``): the whole
    flow — paired concordant screens, trimmed multimap alignment,
    concordance re-screens, rRNA / unigene-prefilter / IG screens and
    file emission — runs in threaded C++ against the shared seed
    indices.  The Python implementation below is the byte-contract
    oracle (``tests/test_frontend_native.py``) and the fallback when the
    native library is unavailable or a custom ``verify_fn`` routes
    candidate verification through the device.
    """
    import os as _os
    out = pathlib.Path(outdir)
    out.mkdir(parents=True, exist_ok=True)

    if (not force_python and verify_fn is None
            and _os.environ.get("DEFUSE_FRONTEND") != "python"):
        from ..cluster import native
        if native.available():
            res = _align_job_native(
                cdna_index=cdna_index, genome_index=genome_index,
                rrna_index=rrna_index, prefilter_index=prefilter_index,
                gene_models=gene_models, ig_genes=ig_genes,
                reads1=reads1, reads2=reads2, out=out,
                max_insert_size=max_insert_size,
                discord_read_trim=discord_read_trim,
                max_paired_alignments=max_paired_alignments,
                dna_concordant_length=dna_concordant_length,
                max_alignments=max_alignments, frag_base=frag_base,
                append=append, write_sam=write_sam)
            if res is not None:
                return res

    # Python oracle path operates on read strings; decode matrix-tuple
    # inputs (native-ingest handoff) when falling back
    reads1 = _as_read_list(reads1)
    reads2 = _as_read_list(reads2)
    n_frags = len(reads1)

    # 1. paired concordant screens
    cdna_al1 = _align_all(cdna_index, reads1, verify_fn=verify_fn)
    cdna_al2 = _align_all(cdna_index, reads2, verify_fn=verify_fn)
    cdna_pairs = _best_proper_pairs(cdna_al1, cdna_al2, max_insert_size)
    genome_al1 = _align_all(genome_index, reads1, verify_fn=verify_fn)
    genome_al2 = _align_all(genome_index, reads2, verify_fn=verify_fn)
    genome_pairs = _best_proper_pairs(genome_al1, genome_al2,
                                      max_insert_size)

    concordant = set(cdna_pairs) | set(genome_pairs)

    cdna_pair_sam = out / "cdna.pair.sam.gz"
    write_pair_sam(cdna_pairs, reads1, reads2, cdna_pair_sam,
                   frag_base=frag_base, append=append)
    cdna_pair_tbl = out / "cdna.pair.tbl"
    write_pair_tbl(cdna_pairs, reads1, reads2, cdna_index.names,
                   cdna_pair_tbl, frag_base=frag_base, append=append)

    # 2. read stats from the proper pairs
    isizes = [isize for (_a1, _a2, isize) in cdna_pairs.values()]
    readlengths = sorted({len(r) for r in reads1} | {len(r)
                                                     for r in reads2})
    if isizes:
        mean = sum(isizes) / len(isizes)
        var = sum(i * i for i in isizes) / len(isizes) - mean ** 2
        stats = ReadStats(len(isizes), mean, var ** 0.5, readlengths[0],
                          readlengths[-1], tuple(readlengths))
    else:
        stats = ReadStats(0, 0.0, 0.0, 0, 0, ())

    # 3. trim + drop concordant
    trimmed1 = [r[:discord_read_trim] for r in reads1]
    trimmed2 = [r[:discord_read_trim] for r in reads2]
    candidates = [f for f in range(n_frags) if f not in concordant]

    # 4. single-end all-alignments of trimmed candidate reads
    def aligned_subset(index, trimmed):
        sub = [trimmed[f] for f in candidates]
        res = _align_all(index, sub, max_alignments=max_alignments,
                         verify_fn=verify_fn)
        return dict(zip(candidates, res))

    cdna_end1 = aligned_subset(cdna_index, trimmed1)
    cdna_end2 = aligned_subset(cdna_index, trimmed2)
    dna_end1 = aligned_subset(genome_index, trimmed1)
    dna_end2 = aligned_subset(genome_index, trimmed2)

    # 5. concordance re-screens
    blacklist: set[int] = set()

    def all_aligns(frag, end):
        per_end = (dna_end1, cdna_end1) if end == 0 else (dna_end2,
                                                          cdna_end2)
        merged = []
        over_cap = False
        for m in per_end:
            a = m.get(frag)
            if a is None:
                over_cap = True
            else:
                merged.extend(a)
        return merged, over_cap

    for frag in candidates:
        counts = []
        genes = [set(), set()]
        region_bins = [set(), set()]
        over_cap_any = False
        for end in (0, 1):
            aligns, over_cap = all_aligns(frag, end)
            over_cap_any |= over_cap
            counts.append(_genomic_loci_count(aligns, gene_models)
                          if aligns else 1)
            ext = dna_concordant_length // 2
            for a in aligns:
                for g in gene_models.calc_overlapping_genes(
                        a.ref_name, (a.start, a.end)):
                    genes[end].add(g)
                chrom = gene_models.calc_genomic_chromosome(a.ref_name)
                regions = gene_models.calc_genomic_regions(
                    a.ref_name, (a.start - ext, a.end + ext))
                if regions:
                    span = (regions[0][0], regions[-1][1])
                    for b in range(span[0] // ext, span[1] // ext + 1):
                        region_bins[end].add((chrom, b))
        if over_cap_any:
            blacklist.add(frag)  # XM-flagged (find_unmappable.pl:36-47)
        if counts[0] * counts[1] > max_paired_alignments:
            blacklist.add(frag)
        if genes[0] & genes[1]:
            blacklist.add(frag)
        if region_bins[0] & region_bins[1]:
            blacklist.add(frag)

    # 6. rRNA screen (untrimmed) + unigene prefilter + IG pairs
    if rrna_index is not None:
        for end_reads in (reads1, reads2):
            sub = [end_reads[f] for f in candidates]
            res = _align_all(rrna_index, sub, verify_fn=verify_fn)
            for f, hits in zip(candidates, res):
                if hits:
                    blacklist.add(f)
    if prefilter_index is not None:
        # paired concordant screen vs the unigene prefilter fasta
        # (alignjob.pl:289-305): untrimmed reads, proper-pair model;
        # concordant fragments blacklisted from the improper set
        sub1 = [reads1[f] for f in candidates]
        sub2 = [reads2[f] for f in candidates]
        pre1 = _align_all(prefilter_index, sub1, verify_fn=verify_fn)
        pre2 = _align_all(prefilter_index, sub2, verify_fn=verify_fn)
        pre_pairs = _best_proper_pairs(pre1, pre2, max_insert_size)
        for i_pos in pre_pairs:
            blacklist.add(candidates[i_pos])
    if ig_genes:
        for frag in candidates:
            ig_hit = [False, False]
            for end, m in ((0, cdna_end1), (1, cdna_end2)):
                for a in (m.get(frag) or []):
                    gene = a.ref_name.split("|", 1)[0]
                    if gene in ig_genes:
                        ig_hit[end] = True
            if ig_hit[0] and ig_hit[1]:
                blacklist.add(frag)

    # 7. improper SAM + spanning rows
    improper_sam = out / "improper.sam"
    spanning = out / "spanning.compact"
    _mode = "a" if append else "w"
    with open(improper_sam, _mode) as sam_out, \
            open(spanning, _mode) as sp_out:
        for frag in candidates:
            if frag in blacklist:
                continue
            rows = []
            ends_present = set()
            for end in (0, 1):
                aligns, _oc = all_aligns(frag, end)
                seq = (trimmed1, trimmed2)[end][frag]
                for a in aligns:
                    rows.append((end, a, seq))
                if aligns:
                    ends_present.add(end)
            for end, a, seq in rows:
                flag = 0x10 if a.strand else 0
                sam_out.write(f"{frag + frag_base}/{end + 1}\t{flag}\t"
                              f"{a.ref_name}\t"
                              f"{a.start}\t255\t{len(seq)}M\t*\t0\t0\t"
                              f"{seq}\t{'I' * len(seq)}\n")
            if len(ends_present) == 2:
                for end, a, seq in rows:
                    sp_out.write(f"{frag + frag_base}\t{end}\t"
                                 f"{a.ref_name}\t"
                                 f"{'-' if a.strand else '+'}\t{a.start}"
                                 f"\t{a.end}\n")

    return {
        "spanning": str(spanning),
        "improper": str(improper_sam),
        "concordant_sam": str(cdna_pair_sam),
        "pair_table": str(cdna_pair_tbl),
        "stats": stats,
        "concordant_fragments": concordant,
        "blacklist": blacklist,
    }


def _as_read_list(reads):
    if not isinstance(reads, tuple):
        return reads
    arr, lens = reads
    return [arr[i, :lens[i]].tobytes().decode() for i in range(len(lens))]


def _align_job_native(*, cdna_index, genome_index, rrna_index,
                      prefilter_index, gene_models, ig_genes, reads1,
                      reads2, out, max_insert_size, discord_read_trim,
                      max_paired_alignments, dna_concordant_length,
                      max_alignments, frag_base=0, append=False,
                      write_sam=True):
    """Native C++ alignjob driver glue (byte-identical outputs to the
    Python path; pinned by tests/test_frontend_native.py).

    ``write_sam=False`` skips the pair-SAM text checkpoint (the binary
    pair table carries the same information, including the end-1 strand
    bit; ``pair_sam_from_tbl`` regenerates the SAM on demand)."""
    from ..cluster import native

    improper_sam = out / "improper.sam"
    spanning = out / "spanning.compact"
    cdna_pair_sam = out / "cdna.pair.sam.gz" if write_sam else ""
    cdna_pair_tbl = out / "cdna.pair.tbl"
    res = native.align_job_native(
        cdna_index=cdna_index, genome_index=genome_index,
        rrna_index=rrna_index, prefilter_index=prefilter_index,
        gene_models=gene_models, ig_genes=ig_genes,
        reads1=reads1, reads2=reads2,
        improper_path=improper_sam, spanning_path=spanning,
        pair_sam_path=cdna_pair_sam, pair_tbl_path=cdna_pair_tbl,
        trim_len=discord_read_trim, max_insert=max_insert_size,
        max_paired=max_paired_alignments,
        concord_len=dna_concordant_length,
        max_alignments=max_alignments, frag_base=frag_base,
        append=append)
    if res is None:
        return None
    (n_pairs, sum_isize, sumsq_isize), concordant, blacklist = res
    import numpy as _np

    def _lenset(reads):
        if isinstance(reads, tuple):
            return set(_np.unique(reads[1]).tolist())
        return {len(r) for r in reads}

    readlengths = sorted(_lenset(reads1) | _lenset(reads2))
    if n_pairs:
        mean = sum_isize / n_pairs
        var = sumsq_isize / n_pairs - mean ** 2
        stats = ReadStats(n_pairs, mean, var ** 0.5, readlengths[0],
                          readlengths[-1], tuple(readlengths))
    else:
        stats = ReadStats(0, 0.0, 0.0, 0, 0, ())
    return {
        "spanning": str(spanning),
        "improper": str(improper_sam),
        "concordant_sam": str(cdna_pair_sam) if write_sam else None,
        "pair_table": str(cdna_pair_tbl),
        "stats": stats,
        "concordant_fragments": concordant,
        "blacklist": blacklist,
    }


def align_reads(config, output_dir, fastq1, fastq2, use_device=True,
                frag_base=0, device="cuda"):
    """Build indices from config-named references and run the frontend;
    returns run_pipeline keyword inputs.

    Routing is the reference's: with ``DEFUSE_DEVICE_VERIFY=auto`` (the
    default) the native fused C++ seed+verify runs when the native library
    is present, and ``DeviceVerifier(device)`` verifies the candidates of
    the Python seed path when it is absent; ``force`` verifies on
    ``device`` regardless; ``off`` or ``use_device=False`` never does.
    ``device="cuda"`` without CUDA raises.  ``frag_base`` offsets fragment
    ids globally when this process owns one shard of a multi-process run.
    """
    dev = require_cuda(device) if use_device else None
    tv = [time.time()]

    def _tmark(label):
        if os.environ.get("DEFUSE_ALIGNJOB_TIMING"):
            now = time.time()
            print(f"[align_reads] {label}: {now - tv[0]:.2f}s", flush=True)
            tv[0] = now

    out = pathlib.Path(output_dir)
    ingested = native.ingest_fastq(fastq1, fastq2, str(out / "reads")) \
        if native.available() else None
    _tmark("fastq ingest")
    if ingested is not None:
        # native ingest: renamed fastqs + .fqi + names written in C++,
        # reads handed to the aligner as char matrices
        reads1, reads2 = ingested
    else:
        reads1, reads2, _names = index_paired_fastq(fastq1, fastq2,
                                                    str(out / "reads"))
    gene_models = GeneModels(config.get_value("gene_models"))

    # short-read libraries (< 3*16bp after trim): for references small
    # enough to rebuild quickly, re-index at k = read_len//3 so the full
    # 2-mismatch pigeonhole guarantee holds; huge references keep the
    # persisted k=16 index with staggered seeds
    if isinstance(reads1, tuple):
        lmax = int(max(reads1[1].max() if len(reads1[1]) else 0,
                       reads2[1].max() if len(reads2[1]) else 0))
    else:
        lmax = max((len(r) for r in list(reads1) + list(reads2)),
                   default=0)
    trim = config.get_int("discord_read_trim")
    eff_len = min(lmax, trim) if lmax else trim
    short_k = None
    if 0 < eff_len < 48:
        genome_bp = 0
        try:
            genome_bp = os.path.getsize(config.get_value("genome_fasta"))
        except OSError:
            pass
        if genome_bp <= 512_000_000:
            short_k = max(8, eff_len // 3)
            print(f"short-read library (<=~{eff_len}bp): rebuilding "
                  f"seed indices at k={short_k} for full 2-mismatch "
                  "sensitivity", flush=True)

    def index_of(key, prefix=None):
        if short_k is not None:
            return SeedIndex(
                FastaStore.from_file(config.get_value(key))._seqs,
                seed_len=short_k)
        return SeedIndex.load_or_build(config.get_value(key), prefix=prefix)

    cdna_index = index_of("cdna_fasta")
    genome_prefix = None
    if short_k is None and config.has_value("dataset_prefix"):
        genome_prefix = config.get_value("dataset_prefix") + ".genome.seedidx"
        if not SeedIndex.saved_exists(genome_prefix):
            genome_prefix = None
    genome_index = index_of("genome_fasta", genome_prefix)
    rrna_index = index_of("rrna_fasta") if config.has_value("rrna_fasta") \
        else None
    # unigene prefilter fastas (config `prefilter1..N`); multiple fastas
    # merge into one index: the screen only asks whether a proper pair
    # exists on any single prefilter sequence
    prefilter_index = None
    prefilter_paths = [p for p in config.get_indexed("prefilter")
                       if p and pathlib.Path(p).exists()]
    if prefilter_paths:
        merged: dict[str, str] = {}
        for p in prefilter_paths:
            merged.update(FastaStore.from_file(p)._seqs)
        if short_k is not None:
            prefilter_index = SeedIndex(merged, seed_len=short_k)
        elif len(prefilter_paths) == 1:
            prefilter_index = SeedIndex.load_or_build(prefilter_paths[0])
        else:
            prefilter_index = SeedIndex(merged)
    _tmark("seed indices")
    ig_genes = set()
    if config.has_value("ig_gene_list"):
        with open(config.get_value("ig_gene_list")) as fh:
            ig_genes = {line.strip() for line in fh if line.strip()}

    # the one change from defuse_tpu: the port's verifier, with no device
    # probe and no cost model; with the native library present, auto mode
    # keeps the fused C++ seed+verify
    verify_fn = None
    mode = os.environ.get("DEFUSE_DEVICE_VERIFY", "auto")
    if dev is not None and mode != "off" \
            and (not native.available() or mode == "force"):
        verify_fn = DeviceVerifier(dev)

    def run_shard(r1, r2, outdir, frag_base=0, append=False):
        return align_job(
            cdna_index=cdna_index, genome_index=genome_index,
            rrna_index=rrna_index, gene_models=gene_models,
            reads1=r1, reads2=r2, outdir=str(outdir),
            max_insert_size=config.get_int("max_insert_size"),
            discord_read_trim=config.get_int("discord_read_trim"),
            max_paired_alignments=config.get_int("max_paired_alignments"),
            dna_concordant_length=config.get_int("dna_concordant_length"),
            ig_genes=ig_genes, verify_fn=verify_fn,
            prefilter_index=prefilter_index, frag_base=frag_base,
            append=append,
            # "lazy" (default) skips the pair-SAM text checkpoint on the
            # native path; consumers regenerate it from the binary table
            write_sam=config.get_value("pair_sam_checkpoint") != "lazy"
            if config.has_value("pair_sam_checkpoint") else False)

    def slice_reads(reads, lo, hi):
        if isinstance(reads, tuple):
            return (reads[0][lo:hi], reads[1][lo:hi])
        return reads[lo:hi]

    n_frags = len(reads1[1]) if isinstance(reads1, tuple) else len(reads1)
    reads_per_job = config.get_int("reads_per_job")
    if n_frags > reads_per_job:
        # data-parallel frontend shards bound per-shard memory at
        # reads_per_job pairs; sequential shards emit globally-correct
        # fragment ids (frag_base) and append straight into the final
        # artifact files (shard 0 truncates)
        res = None
        for si, lo in enumerate(range(0, n_frags, reads_per_job)):
            hi = min(lo + reads_per_job, n_frags)
            res = run_shard(
                slice_reads(reads1, lo, hi), slice_reads(reads2, lo, hi),
                out / "aligned", frag_base=frag_base + lo, append=si > 0)
            _tmark(f"shard {si} ({hi - lo} pairs)")
    else:
        res = run_shard(reads1, reads2, out / "aligned",
                        frag_base=frag_base)
    return {
        "spanning": res["spanning"], "improper": res["improper"],
        "fastq1": str(out / "reads" / "reads.1.fastq"),
        "fastq2": str(out / "reads" / "reads.2.fastq"),
        "concordant_sam": res["concordant_sam"],
        "pair_table": res.get("pair_table"),
        # reuse the indices for the breakpoint alignment stage
        "target_indices": {"genome": genome_index, "cdna": cdna_index},
    }
