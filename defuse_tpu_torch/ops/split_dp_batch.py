"""Batched split-read DP — the plain PyTorch version.

Counterpart of ``defuse_tpu/ops/split_dp_batch.py``: the same int32
recurrence as a row loop over ``torch.cummax`` (the horizontal gap
recurrence is a prefix max with linear decay), bit-exact with the JAX
version and with the host oracle ``align/split_dp.fill_matrix``.  It takes
tensors on any device.  The CPU tests run it, and ``chip_smoke.py`` holds
the CUDA kernel (``ops/split_dp_cuda.py``) against it on the card.
"""

from __future__ import annotations

import numpy as np
import torch

from ..align.split_dp import GAP, MATCH, MIN_SPLIT_SCORE, MISMATCH

NEG = -(1 << 30)


def pad_batch(seqs: list[str], width: int) -> tuple[np.ndarray, np.ndarray]:
    """Encode + right-pad a list of sequences to (B, width) uint8."""
    out = np.zeros((len(seqs), width), dtype=np.uint8)
    lens = np.empty(len(seqs), dtype=np.int32)
    for i, s in enumerate(seqs):
        b = s.encode()
        if len(b) > width:
            raise ValueError(f"sequence longer than pad width {width}")
        out[i, :len(b)] = np.frombuffer(b, dtype=np.uint8)
        lens[i] = len(b)
    return out, lens


def dp_row_maxima(refs, ref_lens, reads, read_lens):
    """Row maxima of the split DP for a batch.

    refs (B, R) and reads (B, L) hold character codes (0 = pad), ref_lens
    and read_lens (B,).  Returns rowmax (B, L+1) int32: the max over valid
    ref columns of DP row j, 0 below MIN_SPLIT_SCORE and for j > read_len.
    """
    B, R = refs.shape
    L = reads.shape[1]
    dev = refs.device
    refs = refs.to(torch.int32)
    reads = reads.to(torch.int32)
    ref_lens = ref_lens.to(torch.int32)
    read_lens = read_lens.to(torch.int32)

    iota_r = torch.arange(R + 1, dtype=torch.int32, device=dev)
    decay = GAP * iota_r
    valid = iota_r[None, :] <= ref_lens[:, None]  # (B, R+1)
    match = torch.tensor(MATCH, dtype=torch.int32, device=dev)
    mismatch = torch.tensor(MISMATCH, dtype=torch.int32, device=dev)
    neg = torch.tensor(NEG, dtype=torch.int32, device=dev)

    prev = torch.zeros((B, R + 1), dtype=torch.int32, device=dev)
    rowmax = torch.zeros((B, L + 1), dtype=torch.int32, device=dev)
    vert = torch.empty((B, R + 1), dtype=torch.int32, device=dev)
    for j in range(1, L + 1):
        sub = torch.where(refs == reads[:, j - 1:j], match, mismatch)
        vert[:, 0] = GAP * j
        torch.maximum(prev[:, :-1] + sub, prev[:, 1:] + GAP, out=vert[:, 1:])
        col = torch.cummax(vert - decay, dim=1).values + decay
        rowmax[:, j] = torch.where(valid, col, neg).amax(dim=1)
        prev = col

    row_valid = torch.arange(L + 1, dtype=torch.int32,
                             device=dev)[None, :] <= read_lens[:, None]
    keep = row_valid & (rowmax >= MIN_SPLIT_SCORE)
    return torch.where(keep, rowmax, torch.zeros_like(rowmax))


def dp_tie_columns(refs, ref_lens, reads, read_lens, row_sel):
    """Tie-column bitmasks for requested DP rows.

    row_sel: (B, M) row indices (-1 for unused slots; 0 names the initial
    all-zero row).  For each requested row, the anchored row maximum (0
    below MIN_SPLIT_SCORE) and a bit-packed mask of the valid columns
    reaching it (``FindMaxRowEntry`` column collection), 32 columns a
    word, column 32*w + i in bit i of word w.

    Returns (rowmax (B, M) int32, packed (B, M, ceil((R+1)/32)) int32).
    ``packed`` holds the uint32 bit pattern of the JAX version's words:
    column 32*w + 31 sets the sign bit, and ``packed.numpy().view(np.uint8)``
    gives the same bytes.  The words are summed in int64 and narrowed.
    """
    B, R = refs.shape
    L = reads.shape[1]
    M = row_sel.shape[1]
    dev = refs.device
    refs = refs.to(torch.int32)
    reads = reads.to(torch.int32)
    ref_lens = ref_lens.to(torch.int32)
    row_sel = row_sel.to(torch.int32)

    iota_r = torch.arange(R + 1, dtype=torch.int32, device=dev)
    decay = GAP * iota_r
    valid = iota_r[None, :] <= ref_lens[:, None]  # (B, R+1)
    match = torch.tensor(MATCH, dtype=torch.int32, device=dev)
    mismatch = torch.tensor(MISMATCH, dtype=torch.int32, device=dev)
    neg = torch.tensor(NEG, dtype=torch.int32, device=dev)

    prev = torch.zeros((B, R + 1), dtype=torch.int32, device=dev)
    rows = torch.where((row_sel == 0)[..., None], prev[:, None, :],
                       neg.expand(B, M, R + 1))
    vert = torch.empty((B, R + 1), dtype=torch.int32, device=dev)
    for j in range(1, L + 1):
        sub = torch.where(refs == reads[:, j - 1:j], match, mismatch)
        vert[:, 0] = GAP * j
        torch.maximum(prev[:, :-1] + sub, prev[:, 1:] + GAP, out=vert[:, 1:])
        col = torch.cummax(vert - decay, dim=1).values + decay
        rows = torch.where((row_sel == j)[..., None], col[:, None, :], rows)
        prev = col

    masked = torch.where(valid[:, None, :], rows, neg)
    rowmax = masked.amax(dim=2)
    anchored = rowmax >= MIN_SPLIT_SCORE
    rowmax = torch.where(anchored, rowmax, torch.zeros_like(rowmax))
    tie = (masked == rowmax[..., None]) & anchored[..., None]

    W = (R + 1 + 31) // 32
    tie_p = torch.nn.functional.pad(tie, (0, W * 32 - (R + 1)))
    weights = torch.ones(32, dtype=torch.int64, device=dev) \
        << torch.arange(32, dtype=torch.int64, device=dev)
    words = (tie_p.reshape(B, M, W, 32).to(torch.int64) * weights).sum(dim=3)
    # narrow the 0..2^32-1 sums to the int32 of the same low 32 bits
    packed = torch.where(words >= (1 << 31), words - (1 << 32),
                         words).to(torch.int32)
    return rowmax, packed


def combine_split_scores(rowmax1, rowmax2, read_lens, min_scores):
    """Split-score search (``SplitReadAligner::GetAlignments`` max phase).

    totals[k] = rm1[k] + rm2[read_len - k] over k <= read_len, 0 below
    ``min_scores``.  Returns (max_score, best_k) int32, best_k the smallest
    k reaching the max; max_score == 0 when no split passes.
    """
    L = rowmax1.shape[1] - 1
    dev = rowmax1.device
    read_lens = read_lens.to(torch.int32)
    ks = torch.arange(L + 1, dtype=torch.int32, device=dev)[None, :]
    k_valid = ks <= read_lens[:, None]
    idx2 = torch.clamp(read_lens[:, None] - ks, 0, L).to(torch.int64)
    totals = rowmax1 + torch.gather(rowmax2, 1, idx2)
    keep = k_valid & (totals >= min_scores.to(torch.int32)[:, None])
    totals = torch.where(keep, totals, torch.zeros_like(totals))
    return totals.amax(dim=1), totals.argmax(dim=1).to(torch.int32)


def screen_candidates_ref(uref1, ulen1, uref2r, ulen2, ref_idx, reads,
                          read_lens, min_scores):
    """Plain candidate screen: per-candidate max split score (0 = reject).

    The same gather, reversal, combine and threshold as
    ``defuse_tpu/ops/split_dp_pallas.py::_screen_candidates``: flank rows
    come from the unique-flank tables by ``ref_idx`` (``uref2r`` holds the
    reversed second flanks) and the second DP runs on the reversed read.
    """
    L = reads.shape[1]
    dev = reads.device
    read_lens = read_lens.to(torch.int32)
    ref_idx = ref_idx.to(torch.int64)
    pos = torch.arange(L, dtype=torch.int32, device=dev)[None, :]
    src = torch.clamp(read_lens[:, None] - 1 - pos, 0, max(L - 1, 0))
    rev = torch.gather(reads, 1, src.to(torch.int64))
    rev = torch.where(pos < read_lens[:, None], rev, torch.zeros_like(rev))

    rm = dp_row_maxima(torch.cat([uref1[ref_idx], uref2r[ref_idx]]),
                       torch.cat([ulen1[ref_idx], ulen2[ref_idx]]),
                       torch.cat([reads, rev]),
                       torch.cat([read_lens, read_lens]))
    B = reads.shape[0]
    max_score, _ = combine_split_scores(rm[:B], rm[B:], read_lens, min_scores)
    return max_score
