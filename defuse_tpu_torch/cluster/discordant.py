"""Discordant mate-pair clustering — the ``clustermatepairs`` equivalent.

Streams per-fragment alignment groups, drops concordant fragments, bins
alignment ends into 32kb genome bins packed into 32-bit ids, accumulates
bin-pair → alignment sets, and runs the mate-pair EM per bin pair
(``tools/clustermatepairs.cpp``).

Ordering contract (see DESIGN.md): bin pairs are processed in ascending
packed-id order and fragments in ascending fragment-index order — the
canonical deterministic order our golden build of the reference also
produces (ordered-container shims).

The binning/packing layout matches ``clustermatepairs.cpp:50-66``:
``id = referenceIndex | strand<<18 | bin<<19`` with 18/1/13 bit fields.
C++ integer division truncates toward zero; we reproduce that for
negative extended coordinates.
"""

from __future__ import annotations

import dataclasses

import numpy as np

from ..core.types import AlignmentTable
from .matepair_em import EMParams, MatePairEM, calc_break_region, strand_remap

BIN_LENGTH = 1 << 15


def _trunc_div(a, b):
    """C-style integer division (truncate toward zero); works on scalars
    (fast path) and arrays."""
    if isinstance(a, (int, np.integer)):
        q = abs(int(a)) // b
        return -q if a < 0 else q
    q = np.abs(a) // b
    return np.where(a < 0, -q, q)


def _get_bins(start, end, bin_length, extend):
    """Bin range for a region (``clustermatepairs.cpp:152-161``)."""
    lo = _trunc_div(int(start) - extend, bin_length)
    hi = _trunc_div(int(end) + extend, bin_length)
    return range(lo, hi + 1)


def pack_refbin(ref: int, strand: int, bin_: int) -> int:
    if ref >= (1 << 18):
        raise ValueError("too many reference sequences")
    if bin_ >= (1 << 13) or bin_ < 0:
        raise ValueError("chromosome too large for 13-bit bins")
    return ref | (strand << 18) | (bin_ << 19)


def bin_relative_pos(bin_: int, pos: int, bin_length: int = BIN_LENGTH) -> int:
    return pos - bin_ * bin_length + bin_length // 2


def bin_absolute_pos(bin_: int, pos: int, bin_length: int = BIN_LENGTH) -> int:
    return pos + bin_ * bin_length - bin_length // 2


@dataclasses.dataclass
class ClusterRow:
    cluster_id: int
    cluster_end: int
    fragment: int
    read_end: int
    ref_name: str
    strand: int
    start: int
    end: int

    def format(self) -> str:
        return "{}\t{}\t{}\t{}\t{}\t{}\t{}\t{}".format(
            self.cluster_id, self.cluster_end, self.fragment, self.read_end,
            self.ref_name, "+" if self.strand == 0 else "-", self.start,
            self.end)


def check_concordant(frag_rows, min_fusion_range: int) -> bool:
    """True if both read ends bin to a common (ref, range-bin)
    (``clustermatepairs.cpp:211-244``)."""
    bins = [set(), set()]
    for (_frag, read_end, ref, _strand, start, end) in frag_rows:
        for b in _get_bins(start, end, min_fusion_range, min_fusion_range):
            bins[read_end].add((ref, b))
    return not bins[0].isdisjoint(bins[1])


def add_bin_pairs(frag_rows, min_fusion_range: int, bin_pairs: dict) -> None:
    """Accumulate a fragment's alignments into bin-pair buckets
    (``clustermatepairs.cpp:246-290``).

    bin_pairs: {(id1, id2): ([(readid, relStart, relEnd)], [...])}
    Bucket iteration within a fragment is in ascending packed-id order
    (canonical; the golden build's ordered shims match).  Rows may carry
    a precomputed bin range as a 7th element.
    """
    binned = [{}, {}]  # per read end: packed refbin id -> [packed alignment]
    for row in frag_rows:
        (frag, read_end, ref, strand, start, end) = row[:6]
        bins = row[6] if len(row) > 6 else _get_bins(
            start, end, BIN_LENGTH, min_fusion_range)
        read_id = frag | (read_end << 31)
        for b in bins:
            rb = pack_refbin(ref, strand, b)
            rel_start = bin_relative_pos(b, start)
            rel_end = bin_relative_pos(b, end)
            if not (0 <= rel_start < (1 << 16) and 0 <= rel_end < (1 << 16)):
                raise AssertionError("relative position out of range")
            binned[read_end].setdefault(rb, []).append(
                (read_id, rel_start, rel_end))

    for rb1 in sorted(binned[0]):
        for rb2 in sorted(binned[1]):
            if rb1 < rb2:
                key, first, second = (rb1, rb2), binned[0][rb1], binned[1][rb2]
            else:
                key, first, second = (rb2, rb1), binned[1][rb2], binned[0][rb1]
            bucket = bin_pairs.setdefault(key, ([], []))
            bucket[0].extend(first)
            bucket[1].extend(second)


def _unpack(refbin_id: int, packed_rows):
    """Unpack alignments of one bin side (``clustermatepairs.cpp:193-209``).

    Returns arrays (fragment, read_end, start, end) plus (ref, strand).
    """
    ref = refbin_id & ((1 << 18) - 1)
    strand = (refbin_id >> 18) & 1
    bin_ = refbin_id >> 19
    frag = np.array([r[0] & 0x7FFFFFFF for r in packed_rows], dtype=np.int64)
    read_end = np.array([(r[0] >> 31) & 1 for r in packed_rows], dtype=np.int64)
    start = np.array([bin_absolute_pos(bin_, r[1]) for r in packed_rows],
                     dtype=np.int64)
    end = np.array([bin_absolute_pos(bin_, r[2]) for r in packed_rows],
                   dtype=np.int64)
    return ref, strand, frag, read_end, start, end


def _filter_overlapping(frag_to_aligns, strand, starts, ends, ref, read_ends,
                        min_fusion_range):
    """Per fragment keep the first alignment per overlap bin
    (``clustermatepairs.cpp:314-358``).  All alignments in a bucket share
    (ref, strand); the bin key still includes them for fidelity."""
    refstrand_id = ref | (strand << 31)
    for frag in frag_to_aligns:
        kept = []
        seen = [set(), set()]
        for ai in frag_to_aligns[frag]:
            bins = list(_get_bins(starts[ai], ends[ai], min_fusion_range, 0))
            end_idx = int(read_ends[ai])
            if any((refstrand_id, b) in seen[end_idx] for b in bins):
                continue
            for b in bins:
                seen[end_idx].add((refstrand_id, b))
            kept.append(ai)
        frag_to_aligns[frag] = kept


@dataclasses.dataclass
class BinPairResult:
    """Clusters discovered within one bin pair, before global numbering."""
    rows: list  # list of list[ClusterRow-args tuples] per cluster


@dataclasses.dataclass
class BinPairTask:
    """One bin pair ready for EM: pair coordinates + output bookkeeping."""
    key: tuple[int, int]
    x: np.ndarray          # remapped end coordinates (pair axis)
    y: np.ndarray
    u: np.ndarray
    pair_a1: np.ndarray    # alignment indices per pair
    pair_a2: np.ndarray
    pair_frag: list
    ref1: int
    strand1: int
    rend1: np.ndarray
    start1: np.ndarray
    end1: np.ndarray
    ref2: int
    strand2: int
    rend2: np.ndarray
    start2: np.ndarray
    end2: np.ndarray


def collect_bin_pair_tasks(table: AlignmentTable, params: EMParams):
    """Phase 1 of clustering: concordance screen + binning + per-bin-pair
    filtering; returns BinPairTask list in canonical key order."""
    min_fusion_range = int(params.fragment_mean + 10 * params.fragment_stddev)

    # --- vectorized concordance screen ----------------------------------
    # C++ semantics (clustermatepairs.cpp:211-244): per fragment, bin each
    # alignment into minFusionRange-length bins extended by minFusionRange;
    # a fragment is concordant when both read ends share a (ref, bin).
    n = len(table)
    frag_col = table.fragment.astype(np.int64)
    starts = table.start.astype(np.int64)
    ends = table.end.astype(np.int64)
    mfr = np.int64(min_fusion_range)
    lo = _trunc_div(starts - mfr, mfr)
    hi = _trunc_div(ends + mfr, mfr)
    counts = (hi - lo + 1).astype(np.int64)
    row_rep = np.repeat(np.arange(n), counts)
    bin_vals = lo[row_rep] + (np.arange(len(row_rep))
                              - np.repeat(np.cumsum(counts) - counts,
                                          counts))
    ref_rep = table.ref.astype(np.int64)[row_rep]
    end_rep = table.read_end.astype(np.int64)[row_rep]
    frag_rep = frag_col[row_rep]
    # sort by (frag, ref, bin, end); both-end duplicates are adjacent
    order = np.lexsort((end_rep, bin_vals, ref_rep, frag_rep))
    fs, rs, bs, es = (frag_rep[order], ref_rep[order], bin_vals[order],
                      end_rep[order])
    same = (fs[:-1] == fs[1:]) & (rs[:-1] == rs[1:]) & (bs[:-1] == bs[1:]) \
        & (es[:-1] != es[1:])
    concordant_frags = set(fs[:-1][same].tolist())

    # precomputed cluster-bin ranges (bin length 2^15, extend mfr)
    clo = _trunc_div(starts - mfr, np.int64(BIN_LENGTH))
    chi = _trunc_div(ends + mfr, np.int64(BIN_LENGTH))

    # --- group rows by fragment in stream order -------------------------
    bin_pairs: dict = {}
    i = 0
    while i < n:
        j = i
        frag = frag_col[i]
        while j < n and frag_col[j] == frag:
            j += 1
        if int(frag) not in concordant_frags:
            rows = [(int(table.fragment[r]), int(table.read_end[r]),
                     int(table.ref[r]), int(table.strand[r]),
                     int(table.start[r]), int(table.end[r]),
                     range(int(clo[r]), int(chi[r]) + 1))
                    for r in range(i, j)]
            add_bin_pairs(rows, min_fusion_range, bin_pairs)
        i = j

    # --- per bin pair: filter -------------------------------------------
    tasks: list[BinPairTask] = []
    for key in sorted(bin_pairs):
        first, second = bin_pairs[key]
        if (len(first) < params.min_cluster_size
                or len(second) < params.min_cluster_size):
            continue

        ref1, strand1, frag1, rend1, start1, end1 = _unpack(key[0], first)
        ref2, strand2, frag2, rend2, start2, end2 = _unpack(key[1], second)

        # fragment -> alignment indices (ascending fragment: canonical)
        frags1: dict = {}
        for ai, f in enumerate(frag1):
            frags1.setdefault(int(f), []).append(ai)
        frags2: dict = {}
        for ai, f in enumerate(frag2):
            frags2.setdefault(int(f), []).append(ai)

        common = sorted(set(frags1) & set(frags2))
        frags1 = {f: frags1[f] for f in common}
        frags2 = {f: frags2[f] for f in common}

        _filter_overlapping(frags1, strand1, start1, end1, ref1, rend1,
                            min_fusion_range)
        _filter_overlapping(frags2, strand2, start2, end2, ref2, rend2,
                            min_fusion_range)

        if (len(frags1) < params.min_cluster_size
                or len(frags2) < params.min_cluster_size):
            continue

        # cartesian align pairs per fragment, ascending fragment order
        pair_a1 = []
        pair_a2 = []
        pair_frag = []
        for f in common:
            for a1 in frags1[f]:
                for a2 in frags2[f]:
                    pair_a1.append(a1)
                    pair_a2.append(a2)
                    pair_frag.append(f)

        if not pair_a1:
            continue

        pair_a1 = np.asarray(pair_a1)
        pair_a2 = np.asarray(pair_a2)

        # mate pair coordinates (MatePairEM::CreateMatePair + DoClustering)
        x_start, x_end = strand_remap_vec(start1[pair_a1], end1[pair_a1],
                                          strand1)
        y_start, y_end = strand_remap_vec(start2[pair_a2], end2[pair_a2],
                                          strand2)
        u = (params.fragment_mean
             - (x_end - x_start + 1).astype(np.float64)
             - (y_end - y_start + 1).astype(np.float64))

        tasks.append(BinPairTask(
            key=key, x=x_end.astype(np.float64), y=y_end.astype(np.float64),
            u=u, pair_a1=pair_a1, pair_a2=pair_a2, pair_frag=pair_frag,
            ref1=ref1, strand1=strand1, rend1=rend1, start1=start1,
            end1=end1, ref2=ref2, strand2=strand2, rend2=rend2,
            start2=start2, end2=end2))

    return tasks


def emit_cluster_rows(tasks, memberships, table: AlignmentTable,
                      params: EMParams):
    """Phase 3: global cluster numbering + row emission
    (``clustermatepairs.cpp:549-583``).  ``memberships[t]`` is the list of
    member-index lists for task t."""
    out_rows: list[ClusterRow] = []
    cluster_id = 0
    for task, clusters in zip(tasks, memberships):
        for members in clusters:
            if len(members) < params.min_cluster_size:
                continue
            seen_frags = set()
            emitted = False
            for m in members:
                f = task.pair_frag[m]
                if f in seen_frags:
                    continue
                seen_frags.add(f)
                a1 = int(task.pair_a1[m])
                a2 = int(task.pair_a2[m])
                out_rows.append(ClusterRow(
                    cluster_id, 0, f, int(task.rend1[a1]),
                    table.ref_names[task.ref1], task.strand1,
                    int(task.start1[a1]), int(task.end1[a1])))
                out_rows.append(ClusterRow(
                    cluster_id, 1, f, int(task.rend2[a2]),
                    table.ref_names[task.ref2], task.strand2,
                    int(task.start2[a2]), int(task.end2[a2])))
                emitted = True
            if emitted:
                cluster_id += 1
    return out_rows


def cluster_alignments(table: AlignmentTable, params: EMParams,
                       use_device: bool = False, em_mode: str = "auto"):
    """Full clustering pass over an alignment table grouped by fragment.

    The table must be grouped by fragment (stream order), as produced by
    the aligner stage.  Returns a list of ClusterRow.

    em_mode:
      "auto"   — native C++ exact EM when built, else the Python oracle
      "native" — native C++ exact EM (bit-identical memberships)
      "oracle" — Python exact oracle
      "device" — the batched device EM, not ported yet (ROADMAP B6/A11)
    ``use_device=True`` upgrades "auto" to "device" when the native
    library is missing, and "device" raises NotImplementedError: pass
    ``em_mode="oracle"`` (exact) or ``use_device=False`` there.
    """
    tasks = collect_bin_pair_tasks(table, params)
    if em_mode == "auto":
        from . import native
        if native.available():
            em_mode = "native"
        elif use_device:
            em_mode = "device"
        else:
            em_mode = "oracle"
    if em_mode == "device":
        raise NotImplementedError(
            "the batched device EM is not ported (ROADMAP B6/A11): pass "
            "em_mode='oracle' or 'native', or use_device=False")
    if not tasks:
        memberships = []
    elif em_mode == "native":
        from . import native
        memberships = native.em_cluster_batch(
            [(t.x, t.y, t.u) for t in tasks], params)
    else:
        em = MatePairEM(params)
        memberships = [em.do_clustering(t.x, t.y, t.u) for t in tasks]
    return emit_cluster_rows(tasks, memberships, table, params)


def strand_remap_vec(start, end, strand):
    if strand == 0:
        return start, end
    return -end, -start


def write_clusters(rows, path: str) -> None:
    with open(path, "w") as out:
        for row in rows:
            out.write(row.format() + "\n")
