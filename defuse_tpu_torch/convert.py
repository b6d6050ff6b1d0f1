"""The state the screen carries across from the JAX package.

The split-read screen has no learned weights: its state is its operand
set, the numpy arrays that ``defuse_tpu``'s ``screen_candidates_pallas``
takes.  ``screen_operands`` checks them on the host (the kernel trusts
indices and lengths) and returns contiguous tensors in the kernel's
dtypes.  Flank columns past every flank length are dropped, as the Pallas
wrapper's static tightening does: they never reach a valid DP column, and
the kernel's per-lane register width follows the table width.
"""

from __future__ import annotations

import numpy as np
import torch

from defuse_tpu.align.split_dp import accept_threshold


def screen_min_scores(read_lens) -> np.ndarray:
    """The ``min_scores`` operand: ``accept_threshold`` of each read
    length, int32."""
    lens, inverse = np.unique(np.asarray(read_lens), return_inverse=True)
    return np.array([accept_threshold(int(n)) for n in lens],
                    dtype=np.int32)[inverse.reshape(-1)]


def _codes(name: str, a) -> np.ndarray:
    a = np.asarray(a)
    if a.ndim != 2:
        raise ValueError(f"{name}: expected 2 dims, got {a.shape}")
    if a.dtype != np.uint8:
        if a.size and (a.min() < 0 or a.max() > 255):
            raise ValueError(f"{name}: character codes outside 0..255")
        a = a.astype(np.uint8)
    return a


def _int32(name: str, a, n: int) -> np.ndarray:
    a = np.asarray(a)
    if a.shape != (n,):
        raise ValueError(f"{name}: expected shape ({n},), got {a.shape}")
    return a.astype(np.int32, copy=False)


def _in_range(name: str, a: np.ndarray, lo: int, hi: int) -> None:
    if a.size and (a.min() < lo or a.max() > hi):
        raise ValueError(f"{name}: values outside [{lo}, {hi}]")


def screen_operands(u1p, u1l, u2rp, u2l, ref_idx, reads, read_lens,
                    min_scores, device):
    """(uref1, ulen1, uref2r, ulen2, ref_idx, reads, read_lens, min_scores)
    as contiguous tensors on ``device``: uint8 codes, int32 the rest."""
    u1p, u2rp = _codes("u1p", u1p), _codes("u2rp", u2rp)
    reads = _codes("reads", reads)
    U, R = u1p.shape
    B, L = reads.shape
    if u2rp.shape != (U, R):
        raise ValueError(f"u2rp: expected {(U, R)}, got {u2rp.shape}")
    u1l, u2l = _int32("u1l", u1l, U), _int32("u2l", u2l, U)
    ref_idx = _int32("ref_idx", ref_idx, B)
    read_lens = _int32("read_lens", read_lens, B)
    min_scores = _int32("min_scores", min_scores, B)
    _in_range("u1l", u1l, 0, R)
    _in_range("u2l", u2l, 0, R)
    _in_range("ref_idx", ref_idx, 0, U - 1)
    _in_range("read_lens", read_lens, 0, L)

    width = max(1, int(max(u1l.max(initial=0), u2l.max(initial=0))))
    arrays = (u1p[:, :width], u1l, u2rp[:, :width], u2l, ref_idx, reads,
              read_lens, min_scores)
    return tuple(torch.from_numpy(np.ascontiguousarray(a)).to(device)
                 for a in arrays)
