"""Data-parallel sharding — ``split_fastq.pl`` / ``divide_sam_chr_pairs.pl``
equivalents plus the associative merge contracts.

The distribution model mirrors the reference (SURVEY.md §2.5) with TPU
collectives in place of the filesystem barrier:

* reads shard into ``reads_per_job`` chunks; each shard runs the aligner
  frontend independently (fragment ids are global, so shard outputs
  concatenate)
* improper/spanning alignments partition by chromosome pair; each
  partition clusters independently; ``merge_clusters`` renumbers
* additive statistics (fragment-length sums/sumsq, expression counts,
  covariance samples) merge associatively — on device via ``psum``
  (see ``__graft_entry__.dryrun_multichip``), on host via
  ``stats.readstats.merge_read_stats`` / ``merge_expression``
"""

from __future__ import annotations

import pathlib


def split_fastq(fastq1: str, fastq2: str, outdir: str,
                reads_per_job: int):
    """Shard renamed fastqs; returns the shard catalog
    (``split_fastq.pl``: catalog lists shard prefixes)."""
    from ..io.readindex import resolve_fastq_pair
    # original-backed stores (index-only ingest): stream the physical
    # files — shard records keep their original headers, which is fine
    # because every shard is re-ingested (and re-renamed) by its own
    # frontend run
    (fastq1, fastq2), _backed, _fqi = resolve_fastq_pair(fastq1, fastq2)
    out = pathlib.Path(outdir)
    out.mkdir(parents=True, exist_ok=True)
    prefixes = []

    def shard_one(path, end):
        shard = -1
        count = reads_per_job
        fh_out = None
        with open(path) as fh:
            while True:
                rec = [fh.readline() for _ in range(4)]
                if not rec[0]:
                    break
                if count >= reads_per_job:
                    if fh_out:
                        fh_out.close()
                    shard += 1
                    count = 0
                    prefix = out / f"reads.{shard}"
                    if end == 1:
                        prefixes.append(str(prefix))
                    fh_out = open(f"{prefix}.{end}.fastq", "w")
                fh_out.writelines(rec)
                count += 1
        if fh_out:
            fh_out.close()

    shard_one(fastq1, 1)
    shard_one(fastq2, 2)
    catalog = out / "reads.split.catalog"
    with open(catalog, "w") as fh:
        for p in prefixes:
            fh.write(p + "\n")
    return prefixes


def merge_cluster_parts(part_paths, sidecar_paths, out_path):
    """Interleave per-rank cluster partitions back into the exact
    single-process clusters file.

    Rank r owns bin pairs with canonical index ≡ r (mod n); its part
    file holds their clusters (locally renumbered 0,1,2,…, groups in
    canonical order) and its sidecar one line per owned bin pair — the
    number of clusters that pair produced.  Walking the global bin-pair
    index and taking the next ``count`` cluster groups from the owning
    rank reproduces the single-process emission order; cluster ids are
    rewritten sequentially.  Byte-identical output is pinned by
    tests/test_distributed_tail.py."""
    n = len(part_paths)
    counts = []
    for sp in sidecar_paths:
        with open(sp) as fh:
            counts.append([int(x) for x in fh])
    readers = [open(p) for p in part_paths]
    pending = [None] * n  # lookahead line per reader
    next_item = [0] * n

    def take_groups(r, k, out, cid):
        """Copy k cluster groups (consecutive lines sharing the leading
        id field) from reader r, renumbering ids sequentially."""
        fh = readers[r]
        line = pending[r] if pending[r] is not None else fh.readline()
        pending[r] = None
        for _ in range(k):
            if not line:
                raise ValueError(
                    f"cluster part {part_paths[r]} ended early")
            gid = line[: line.index("\t")]
            prefix = gid + "\t"
            while line.startswith(prefix):
                out.write(f"{cid}{line[len(gid):]}")
                line = fh.readline()
            cid += 1
        pending[r] = line if line else None
        return cid

    total_items = sum(len(c) for c in counts)
    tmp = str(out_path) + ".tmp"
    cid = 0
    try:
        with open(tmp, "w") as out:
            for idx in range(total_items):
                r = idx % n
                k = counts[r][next_item[r]]
                next_item[r] += 1
                if k:
                    cid = take_groups(r, k, out, cid)
        # exhaustion check (ADVICE r4): a part file holding MORE cluster
        # groups than its sidecar claims would otherwise have its
        # trailing clusters silently dropped — the mirror image of the
        # 'ended early' error above, and just as much a
        # corrupted-partition signal
        for r, fh in enumerate(readers):
            leftover = (pending[r] if pending[r] is not None
                        else fh.readline())
            if leftover:
                raise ValueError(
                    f"cluster part {part_paths[r]} has trailing "
                    "clusters beyond its sidecar's counts "
                    f"(first: {leftover[:80]!r})")
    finally:
        for fh in readers:
            fh.close()
    import os
    os.replace(tmp, out_path)


def divide_spanning_by_chr_pair(rows, chrom_of):
    """Partition spanning compact rows by (sorted) chromosome pair
    (``divide_sam_chr_pairs.pl``): per fragment, the cartesian product of
    end-1 and end-2 chromosomes; rows fan out to each matching pair."""
    partitions: dict[tuple[str, str], list[str]] = {}
    current: list = []
    current_frag = None

    def flush(rows_of_frag):
        by_end: dict[int, dict[str, list[str]]] = {0: {}, 1: {}}
        for line in rows_of_frag:
            f = line.rstrip("\n").split("\t")
            chrom = chrom_of(f[2])
            by_end[int(f[1])].setdefault(chrom, []).append(line)
        if not by_end[0] or not by_end[1]:
            return
        for c1 in by_end[0]:
            for c2 in by_end[1]:
                key = tuple(sorted((c1, c2)))
                partitions.setdefault(key, []).extend(by_end[0][c1])
                partitions.setdefault(key, []).extend(by_end[1][c2])

    for line in rows:
        frag = line.split("\t", 1)[0]
        if current_frag is not None and frag != current_frag:
            flush(current)
            current = []
        current_frag = frag
        current.append(line)
    if current:
        flush(current)
    return partitions


def merge_frontend_shards(shard_results, shard_offsets, outdir,
                          ids_global=False):
    """Merge per-shard frontend artifacts into global-id files
    (``defuse_run.pl:387-400`` merge semantics; byte-identical to the
    unsharded run — pinned by ``tests/test_pipeline_sharded.py`` /
    ``test_frontend_sharding``).

    shard_results: list of align_job result dicts; shard_offsets: global
    fragment-id base per shard.  ``ids_global=True`` marks shards that
    already wrote global fragment ids (align_job ``frag_base``): the
    text/gz artifacts are then raw-byte appended with no id rewrite
    (concatenated gzip members are a valid stream), turning the merge
    into pure sequential IO.  Returns a merged result dict.
    """
    from ..stats.readstats import merge_read_stats

    out = pathlib.Path(outdir)
    out.mkdir(parents=True, exist_ok=True)
    merged = {"spanning": out / "spanning.compact",
              "improper": out / "improper.sam",
              "concordant_sam": out / "cdna.pair.sam.gz"}
    for path in merged.values():
        if path.exists():
            path.unlink()

    def globalize(src, dst, offset, qname_style):
        # each shard appends one gzip member to a .gz destination —
        # concatenated members are a valid stream, so shard merge stays
        # append-only (reads are magic-sniffed, never extension-trusted)
        import gzip

        from ..cluster import native
        from ..io.sam import open_text
        if ids_global:
            import shutil
            with open(src, "rb") as fin, open(dst, "ab") as fout:
                shutil.copyfileobj(fin, fout, 1 << 22)
            return
        if native.globalize_ids(src, dst, offset, qname_style) is not None:
            return
        if str(dst).endswith(".gz"):
            fout_ctx = gzip.open(dst, "at", compresslevel=1)
        else:
            fout_ctx = open(dst, "a")
        with open_text(src) as fin, fout_ctx as fout:
            for line in fin:
                f = line.split("\t")
                if qname_style == "frag/end":
                    frag, end = f[0].split("/")
                    f[0] = f"{int(frag) + offset}/{end}"
                else:
                    f[0] = str(int(f[0]) + offset)
                fout.write("\t".join(f))

    concordant: set[int] = set()
    blacklist: set[int] = set()
    have_sam = all(r.get("concordant_sam") for r in shard_results)
    for res, offset in zip(shard_results, shard_offsets):
        globalize(res["spanning"], merged["spanning"], offset, "frag")
        globalize(res["improper"], merged["improper"], offset,
                  "frag/end")
        if have_sam:  # lazy checkpoint: regenerable from the table
            globalize(res["concordant_sam"], merged["concordant_sam"],
                      offset, "sam")
        concordant |= {f + offset for f in res["concordant_fragments"]}
        blacklist |= {f + offset for f in res["blacklist"]}

    tbl_parts = [r.get("pair_table") for r in shard_results]
    merged_tbl = None
    if all(p and pathlib.Path(p).exists() for p in tbl_parts):
        merged_tbl = out / "cdna.pair.tbl"
        merge_pair_tables(tbl_parts,
                          [0] * len(tbl_parts) if ids_global
                          else shard_offsets, merged_tbl)

    stats = merge_read_stats([r["stats"] for r in shard_results])
    return {
        "spanning": str(merged["spanning"]),
        "improper": str(merged["improper"]),
        "concordant_sam": str(merged["concordant_sam"]) if have_sam
        else None,
        "pair_table": str(merged_tbl) if merged_tbl else None,
        "stats": stats,
        "concordant_fragments": concordant,
        "blacklist": blacklist,
    }


# v2 packs the end-1 strand into the seq high bit; v1 (pre-bit) tables
# still load, but strand-dependent consumers must check
# pair_table_has_strand first
PAIR_TBL_MAGIC = b"DPTBL2\n\x00"
PAIR_TBL_MAGIC_V1 = b"DPTBL1\n\x00"
PAIR_REC_DTYPE = [("frag", "<i8"), ("seq", "<i4"), ("pos1", "<i4"),
                  ("len1", "<i4"), ("pos2", "<i4"), ("len2", "<i4"),
                  ("isize", "<i4")]


def read_pair_table(path):
    """(names, records) from a binary pair table (native PairRec
    layout).  A file may hold several concatenated self-describing
    segments (append-mode shard writes); all must share one name
    table and their records concatenate in file order."""
    import numpy as np
    names = None
    chunks = []
    with open(path, "rb") as fh:
        while True:
            magic = fh.read(8)
            if not magic and names is not None:
                break
            if magic not in (PAIR_TBL_MAGIC, PAIR_TBL_MAGIC_V1):
                raise ValueError(f"bad pair table magic: {path}")
            n_pairs, n_names, blob_len = np.frombuffer(fh.read(24),
                                                       "<i8")
            off = np.frombuffer(fh.read(8 * (n_names + 1)), "<i8")
            blob = fh.read(blob_len)
            seg_names = [blob[off[i]:off[i + 1]].decode()
                         for i in range(n_names)]
            if names is None:
                names = seg_names
            elif seg_names != names:
                raise ValueError(
                    f"pair table segments disagree on names: {path}")
            chunks.append(np.frombuffer(fh.read(32 * int(n_pairs)),
                                        dtype=PAIR_REC_DTYPE))
    recs = np.concatenate(chunks) if len(chunks) > 1 else chunks[0]
    return names, recs


def pair_table_has_strand(path) -> bool:
    """True when every segment of the table carries the packed end-1
    strand bit (magic DPTBL2); v1 tables decode as all-forward and must
    not feed strand-dependent consumers (SAM regeneration,
    index_tbl_by_ref)."""
    with open(path, "rb") as fh:
        import numpy as np
        while True:
            magic = fh.read(8)
            if not magic:
                return True
            if magic == PAIR_TBL_MAGIC_V1:
                return False
            if magic != PAIR_TBL_MAGIC:
                raise ValueError(f"bad pair table magic: {path}")
            n_pairs, n_names, blob_len = np.frombuffer(fh.read(24),
                                                       "<i8")
            fh.seek(8 * (n_names + 1) + blob_len + 32 * int(n_pairs), 1)


def unpack_seq_strand(recs):
    """Split the packed ``seq`` field into (name index, end-1 strand).
    The v2 writer packs the end-1 strand into the seq high bit (name
    indices stay < 2^31); v1 records have the bit clear and read back
    as all-forward — gate on ``pair_table_has_strand`` where the
    strand matters."""
    import numpy as np
    raw = recs["seq"].astype(np.int64) & 0xFFFFFFFF
    return (raw & 0x7FFFFFFF).astype(np.int64), \
        (raw >> 31).astype(np.uint8)


def _iter_segment_headers(path):
    """Yield (names, n_pairs) per segment of a pair table, seeking past
    the record payloads (header-only scan; no record parse)."""
    import numpy as np
    with open(path, "rb") as fh:
        first = True
        while True:
            magic = fh.read(8)
            if not magic and not first:
                return
            if magic not in (PAIR_TBL_MAGIC, PAIR_TBL_MAGIC_V1):
                raise ValueError(f"bad pair table magic: {path}")
            n_pairs, n_names, blob_len = np.frombuffer(fh.read(24),
                                                       "<i8")
            off = np.frombuffer(fh.read(8 * (n_names + 1)), "<i8")
            blob = fh.read(blob_len)
            names = [blob[off[i]:off[i + 1]].decode()
                     for i in range(n_names)]
            yield names, int(n_pairs)
            fh.seek(32 * int(n_pairs), 1)
            first = False


def merge_pair_tables(parts, offsets, dst):
    """Concatenate per-shard pair tables with global fragment ids.

    With any nonzero offset the records are rewritten (fragment ids
    globalized) into one segment.  With all-zero offsets (ids already
    global — the multi-process contract) the parts byte-concatenate:
    the format is self-describing multi-segment and every reader
    (python ``read_pair_table``, the native table scan) consumes
    concatenated segments, so the merge is pure IO — no parse, no
    rewrite (was 5.5s of the 4-process rank-0 tail at 10M pairs).
    Name tables are still validated to match across parts."""
    import numpy as np
    if parts and not any(offsets):
        names0 = None
        for p in parts:
            for names, _n in _iter_segment_headers(p):
                if names0 is None:
                    names0 = names
                elif names != names0:
                    raise ValueError("pair table name tables differ "
                                     "across shards (indices must "
                                     "match)")
        import shutil
        tmp = str(dst) + ".tmp"
        with open(tmp, "wb") as out:
            for p in parts:
                with open(p, "rb") as src:
                    shutil.copyfileobj(src, out, 1 << 24)
        import os
        os.replace(tmp, dst)
        return
    all_names = None
    chunks = []
    for path, offset in zip(parts, offsets):
        names, recs = read_pair_table(path)
        if all_names is None:
            all_names = names
        elif names != all_names:
            raise ValueError("pair table name tables differ across "
                             "shards (indices must match)")
        if offset:
            recs = recs.copy()
            recs["frag"] += offset
        chunks.append(recs)
    merged = np.concatenate(chunks) if chunks else \
        np.zeros(0, dtype=PAIR_REC_DTYPE)
    blob = "".join(all_names or []).encode()
    off = np.zeros(len(all_names or []) + 1, dtype="<i8")
    for i, n in enumerate(all_names or []):
        off[i + 1] = off[i] + len(n.encode())
    # a merge of any pre-strand-bit (v1) part must not claim v2
    magic = PAIR_TBL_MAGIC if all(pair_table_has_strand(p)
                                  for p in parts) else PAIR_TBL_MAGIC_V1
    with open(dst, "wb") as fh:
        fh.write(magic)
        fh.write(np.int64(len(merged)).tobytes())
        fh.write(np.int64(len(all_names or [])).tobytes())
        fh.write(np.int64(off[-1]).tobytes())
        fh.write(off.tobytes())
        fh.write(blob)
        fh.write(merged.tobytes())
