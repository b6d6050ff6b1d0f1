"""Batched split-read realignment: device screening + host enumeration.

The sequential realigner (``align/tasks.py``) aligns each nominated
candidate read with the host DP.  This module produces byte-identical
rows with a three-stage batched flow:

1. **Collect** candidates by streaming the improper SAM against the
   binned mate regions (host, same nomination order as the reference).
2. **Screen** all candidates on the card: the CUDA split-DP kernel +
   split-score combine yield each candidate's max split score (int32,
   bit-exact) — rejected candidates (the common case on real data) cost
   nothing further.
3. **Enumerate** accepted candidates' tie columns with a numpy-batched
   row replay (only the rows of winning split offsets are kept).

Rows are emitted in the sequential order (improper-record order, then
candidate order, then k/i1/i2 ascending).
"""

from __future__ import annotations

import dataclasses

import numpy as np

from .split_dp import (GAP, MATCH, MIN_SPLIT_SCORE, MISMATCH,
                       accept_threshold)
from .tasks import SplitRow, _signed32


@dataclasses.dataclass
class Candidate:
    order: int
    cluster_id: int
    fragment: int
    read_end: int
    rev_comp: int
    read_seq: str


def collect_candidates(realigner, mate_alignments) -> list[Candidate]:
    """Stage 1: nominate candidates in reference order
    (``SplitAlignment.cpp:266-303``)."""
    from ..core.types import revcomp as _rc

    out: list[Candidate] = []
    candidate_unique: dict[int, set] = {}
    order = 0
    for aln in mate_alignments:
        ids = realigner.binned.overlapping(aln.reference, aln.strand,
                                           aln.start, aln.end)
        for cid in sorted(ids, key=_signed32):
            cluster_id = cid & 0x7FFFFFFF
            cluster_end = (cid >> 31) & 1
            fragment = int(aln.fragment)
            read_end = 0 if aln.read_end == 1 else 1
            rev_comp = 1 if cluster_end == 0 else 0
            read_id = fragment | (read_end << 31)
            seen = candidate_unique.setdefault(cluster_id, set())
            if (read_id, rev_comp) in seen:
                continue
            seen.add((read_id, rev_comp))
            read_seq = realigner.reads.get(read_id, "")
            if rev_comp:
                read_seq = _rc(read_seq)
            out.append(Candidate(order, cluster_id, fragment, read_end,
                                 rev_comp, read_seq))
            order += 1
    return out


def _np_rows(refs, reads, wanted_rows, R):
    """numpy-batched DP replay keeping only requested rows.

    refs: (B,) strings; reads: (B,) strings; wanted_rows: list of sets.
    Returns dict (b, j) -> row array (int32, len(ref)+1).
    """
    B = len(refs)
    L = max((len(r) for r in reads), default=0)
    enc_ref = np.zeros((B, R), dtype=np.uint8)
    ref_lens = np.zeros(B, dtype=np.int64)
    for i, s in enumerate(refs):
        b = s.encode()
        enc_ref[i, :len(b)] = np.frombuffer(b, np.uint8)
        ref_lens[i] = len(b)
    enc_read = np.zeros((B, L), dtype=np.uint8)
    read_lens = np.zeros(B, dtype=np.int64)
    for i, s in enumerate(reads):
        b = s.encode()
        enc_read[i, :len(b)] = np.frombuffer(b, np.uint8)
        read_lens[i] = len(b)

    iota = np.arange(R + 1, dtype=np.int32)
    decay = GAP * iota
    prev = np.zeros((B, R + 1), dtype=np.int32)
    out: dict[tuple[int, int], np.ndarray] = {}
    # invert wanted_rows: j -> [b], so the row loop only touches askers
    wanted_by_j: dict[int, list[int]] = {}
    for b, rows in enumerate(wanted_rows):
        for j in rows:
            wanted_by_j.setdefault(j, []).append(b)
    for b in wanted_by_j.get(0, ()):
        out[(b, 0)] = np.zeros(int(ref_lens[b]) + 1, dtype=np.int32)
    for j in range(1, L + 1):
        ch = enc_read[:, j - 1][:, None]
        sub = np.where(enc_ref == ch, MATCH, MISMATCH).astype(np.int32)
        vert = np.empty((B, R + 1), dtype=np.int32)
        vert[:, 0] = GAP * j
        vert[:, 1:] = np.maximum(prev[:, :-1] + sub, prev[:, 1:] + GAP)
        col = np.maximum.accumulate(vert - decay, axis=1) + decay
        # read rows beyond a read's length are garbage; callers never ask
        for b in wanted_by_j.get(j, ()):
            out[(b, j)] = col[b, :int(ref_lens[b]) + 1].copy()
        prev = col
    return out


def collect_candidates_native(realigner, improper_path: str
                              ) -> list[Candidate]:
    """Stage 1 in native C++: parse + binned-region lookup + dedup
    (byte-identical candidate order to ``collect_candidates``)."""
    from ..cluster import native
    from ..core.types import revcomp as _rc

    packed = native.collect_candidates(improper_path, realigner.binned)
    out: list[Candidate] = []
    reads = realigner.reads
    for order, (cluster_id, fragment, read_end, rev_comp) in enumerate(
            packed.tolist()):
        read_seq = reads.get(fragment | (read_end << 31), "")
        if rev_comp:
            read_seq = _rc(read_seq)
        out.append(Candidate(order, cluster_id, fragment, read_end,
                             rev_comp, read_seq))
    return out


def _native_rows(ref1s, ref2s, reads, candidates, subset=None):
    """Emit SplitRows via the native realigner.  ``subset`` restricts to
    those candidate indices (screen survivors), preserving order."""
    from ..cluster import native
    if subset is None:
        idx = list(range(len(candidates)))
    else:
        idx = list(subset)
    packed = native.split_realign([ref1s[b] for b in idx],
                                  [ref2s[b] for b in idx],
                                  [reads[b] for b in idx])
    out_rows: list[SplitRow] = []
    for ci, i1, j2, k, score in packed.tolist():
        b = idx[ci]
        c = candidates[b]
        ln = len(reads[b])
        out_rows.append(SplitRow(
            c.cluster_id, c.fragment, c.read_end, c.rev_comp,
            (i1, j2), (k, ln - k), score))
    return out_rows


def realign_candidates_native(realigner,
                              candidates: list[Candidate]) -> list[SplitRow]:
    """Stages 2+3 fully in native C++ (threaded) — the host fast path
    when no device is in use.  Byte-identical rows to
    ``realign_candidates`` (pinned by tests/test_split_chain_parity)."""
    if not candidates:
        return []
    tasks = realigner.tasks
    ref1s = [tasks[c.cluster_id].split_align_seq[0] for c in candidates]
    ref2s = [tasks[c.cluster_id].split_align_seq[1] for c in candidates]
    reads = [c.read_seq for c in candidates]
    return _native_rows(ref1s, ref2s, reads, candidates)


def realign_candidates(realigner, candidates: list[Candidate],
                       rowmax_fn, native_enum: bool = False,
                       device="cuda") -> list[SplitRow]:
    """Stages 2+3.  ``rowmax_fn(refs_p, ref_lens, reads_p, read_lens)``
    computes DP row maxima on numpy operands.  With
    ``native_enum`` the tie-column enumeration of screen survivors runs
    in native C++ instead of a second device round trip; without it the
    enumeration is ``dp_tie_columns`` on ``device``."""
    if not candidates:
        return []

    tasks = realigner.tasks
    ref1s = [tasks[c.cluster_id].split_align_seq[0] for c in candidates]
    ref2s = [tasks[c.cluster_id].split_align_seq[1] for c in candidates]
    reads = [c.read_seq for c in candidates]

    from ..ops.split_dp_batch import pad_batch
    R = _pad_len(max((max(len(a), len(b)) for a, b in zip(ref1s, ref2s)),
                     default=1))
    L = _pad_len(max((len(r) for r in reads), default=1), 64)

    r1p, r1l = pad_batch(ref1s, R)
    r2p, r2l = pad_batch([s[::-1] for s in ref2s], R)
    rp, rl = pad_batch(reads, L)
    rrp, _ = pad_batch([s[::-1] for s in reads], L)

    # one fused device call for forward + reversed matrices
    rm_both = np.asarray(rowmax_fn(
        np.concatenate([r1p, r2p]), np.concatenate([r1l, r2l]),
        np.concatenate([rp, rrp]), np.concatenate([rl, rl])))
    n = len(candidates)
    rm1 = rm_both[:n]
    rm2 = rm_both[n:]

    # vectorized combine (exact ints): totals[k] = rm1[k] + rm2[len-k]
    Lp1 = rm1.shape[1]
    ks_idx = np.arange(Lp1, dtype=np.int64)
    idx2 = np.clip(rl[:, None] - ks_idx[None, :], 0, Lp1 - 1)
    totals = rm1 + np.take_along_axis(rm2, idx2, axis=1)
    totals[ks_idx[None, :] > rl[:, None]] = 0
    min_scores = np.array([accept_threshold(int(l)) for l in rl])
    totals[totals < min_scores[:, None]] = 0
    max_scores = totals.max(axis=1)

    if native_enum:
        survivors = np.nonzero(max_scores > 0)[0].tolist()
        if not survivors:
            return []
        return _native_rows(ref1s, ref2s, reads, candidates,
                            subset=survivors)

    winners = []
    wanted1 = [set() for _ in range(n)]
    wanted2 = [set() for _ in range(n)]
    for b in np.nonzero(max_scores > 0)[0]:
        ln = int(rl[b])
        ks = np.nonzero(totals[b] == max_scores[b])[0].tolist()
        winners.append((int(b), int(max_scores[b]), ks))
        wanted1[b] = set(ks)
        wanted2[b] = {ln - k for k in ks}

    if not winners:
        return []

    # tie-column enumeration for accepted candidates — on device, with
    # bit-packed transfer
    win_idx = [b for (b, _s, _k) in winners]
    max_rows = max(max(len(wanted1[b]), len(wanted2[b]))
                   for b in win_idx)
    # both sides in one call: flank 1 with the read, reversed flank 2 with
    # the reversed read
    cols1_map, cols2_map = _device_tie_columns(
        [([ref1s[b] for b in win_idx], [reads[b] for b in win_idx],
          [sorted(wanted1[b]) for b in win_idx], r1l[win_idx]),
         ([ref2s[b][::-1] for b in win_idx],
          [reads[b][::-1] for b in win_idx],
          [sorted(wanted2[b]) for b in win_idx], r2l[win_idx])],
        win_idx, R, max_rows, device)

    out_rows: list[SplitRow] = []
    for (b, max_score, ks) in winners:
        c = candidates[b]
        ln = int(rl[b])
        seen_splits = set()
        for k in ks:
            s1 = int(rm1[b, k])
            s2 = int(rm2[b, ln - k])
            # a side with anchored max 0 collects no columns -> no rows
            # from this k (FindMaxRowEntry semantics)
            cols1 = cols1_map.get((b, k), [])
            cols2 = cols2_map.get((b, ln - k), [])
            for i1 in cols1:
                for i2 in cols2:
                    ref_split = (int(i1), len(ref2s[b]) - int(i2) - 1)
                    if ref_split in seen_splits:
                        continue
                    seen_splits.add(ref_split)
                    out_rows.append(SplitRow(
                        c.cluster_id, c.fragment, c.read_end, c.rev_comp,
                        ref_split, (k, ln - k), min(s1, s2)))
    return out_rows


def _columns(row, target):
    """Columns achieving the (anchored) row max — mirrors
    ``FindMaxRowEntry`` with column collection
    (``SplitReadAligner.cpp:104-122``): entries must be >= MIN_SPLIT_SCORE
    and equal the max; a max of 0 collects nothing."""
    if target < MIN_SPLIT_SCORE:
        return []
    return np.nonzero(row == target)[0].tolist()


def _pad_len(x: int, mult: int = 128) -> int:
    return (x + mult - 1) // mult * mult


def _device_tie_columns(sides, win_idx, R, max_rows, device="cuda"):
    """Tie columns via ``ops.split_dp_cuda.dp_tie_columns_cuda`` on
    ``device`` (the kernel on a CUDA device, the plain version on the CPU),
    every side in one call.  ``sides`` holds (refs, reads, wanted_rows,
    ref_lens_sub) of the candidates ``win_idx``, each side as the
    reference's ``_device_tie_columns`` takes it.  Returns one
    {(original_b, j): [columns]} a side (anchored-max semantics built in:
    rows whose max is below MIN_SPLIT_SCORE get no columns)."""
    from ..convert import tie_operands
    from ..core.devices import require_cuda
    from ..ops.split_dp_batch import pad_batch
    from ..ops.split_dp_cuda import dp_tie_columns_cuda

    B = len(win_idx)
    L = _pad_len(max(len(r) for _refs, reads, _w, _l in sides
                     for r in reads), 64)
    refs_p, _rl = pad_batch([r for refs, *_ in sides for r in refs], R)
    reads_p, _ql = pad_batch([r for _refs, reads, *_ in sides
                              for r in reads], L)
    row_sel = np.full((B * len(sides), max_rows), -1, dtype=np.int32)
    wanted = [rows for _refs, _reads, side_rows, _l in sides
              for rows in side_rows]
    for i, rows in enumerate(wanted):
        row_sel[i, :len(rows)] = rows
    rowmax, packed = dp_tie_columns_cuda(*tie_operands(
        refs_p, _rl, reads_p, _ql, row_sel, require_cuda(device)))
    packed = np.ascontiguousarray(packed.cpu().numpy())
    rowmax = rowmax.cpu().numpy()
    W = packed.shape[2]
    bits = np.unpackbits(
        packed.view(np.uint8).reshape(len(wanted), max_rows, W, 4),
        axis=3, bitorder="little").reshape(len(wanted), max_rows, W * 32)
    out = []
    for k, (_refs, _reads, side_rows, ref_lens_sub) in enumerate(sides):
        result = {}
        for i, rows in enumerate(side_rows):
            b, row = win_idx[i], k * B + i
            n_ref = int(ref_lens_sub[i])
            for m, j in enumerate(rows):
                if rowmax[row, m] < MIN_SPLIT_SCORE:
                    result[(b, j)] = []
                else:
                    result[(b, j)] = np.nonzero(
                        bits[row, m, :n_ref + 1])[0].tolist()
        out.append(result)
    return out
