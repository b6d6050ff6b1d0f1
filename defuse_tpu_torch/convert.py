"""The state the kernels carry across from the JAX package.

The device stages have no learned weights: their state is their operand
sets, the numpy arrays that ``defuse_tpu``'s device calls take.

* ``screen_operands``: the split-read screen's (``screen_candidates_pallas``
  takes them).  Flank columns past every flank length are dropped, as the
  Pallas wrapper's static tightening does: they never reach a valid DP
  column, and the kernel's per-lane register width follows the table
  width.
* ``verify_plane`` / ``verify_operands``: the packed candidate
  verification's (``DeviceVerifier`` builds them in ``defuse_tpu``).

Each checks its arrays on the host (the kernels trust indices and
lengths) and returns contiguous tensors in the kernel's dtypes.
"""

from __future__ import annotations

import numpy as np
import torch

from .align.split_dp import accept_threshold

from .ops.verify_batch import BASES_PER_WORD, pack_codes3, pack_rows3

MAX_VERIFY_BASES = (1 << 31) * BASES_PER_WORD


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
    return _tensors(arrays, device)


def _tensors(arrays, device):
    return tuple(torch.from_numpy(np.ascontiguousarray(a)).to(device)
                 for a in arrays)


def verify_plane(codes, device) -> torch.Tensor:
    """The reference codes (0..4, N = 4) as the packed 3-bit plane, an
    (ceil(N/10),) int32 tensor on ``device``.  Raises for references of
    2^31 * 10 bases or more, whose word indices leave int32, as
    ``defuse_tpu``'s verifier does."""
    if len(codes) >= MAX_VERIFY_BASES:
        raise NotImplementedError(
            "3-bit packed verify addresses references < ~21 Gbp; shard the "
            "reference across indices beyond that")
    codes = np.asarray(codes)
    _in_range("codes", codes, 0, 4)
    return _tensors((pack_codes3(codes).view(np.int32),), device)[0]


def verify_operands(codes, cand_pos, reads_codes, read_idx, read_lens,
                    device, ref3=None):
    """(ref3, word10, lane10, reads3, read_idx, read_lens): the operands of
    ``ops.verify_cuda.verify_packed3`` on ``device``, int32 but for
    ``lane10``, which is uint8.

    ``codes`` is the reference (``SeedIndex.codes``), ``cand_pos`` the
    candidates' global starts, ``reads_codes`` (B, L) the reads' codes and
    ``read_idx`` (C,) the read of each candidate.  Starts are clipped to
    the reference (the caller drops out-of-bounds placements afterwards)
    and split on the host into (start // 10, start % 10), so device
    indices stay int32.  ``ref3`` passes a plane already on the device
    (``verify_plane``); it is packed here when None.
    """
    if ref3 is None:
        ref3 = verify_plane(codes, device)
    reads_codes = np.asarray(reads_codes)
    if reads_codes.ndim != 2:
        raise ValueError(f"reads_codes: expected 2 dims, got "
                         f"{reads_codes.shape}")
    _in_range("reads_codes", reads_codes, 0, 4)
    B = reads_codes.shape[0]
    starts = np.clip(np.asarray(cand_pos, np.int64), 0,
                     max(0, len(codes) - 1))
    word10 = (starts // BASES_PER_WORD).astype(np.int32)
    lane10 = (starts % BASES_PER_WORD).astype(np.uint8)
    read_idx = _int32("read_idx", read_idx, len(starts))
    _in_range("read_idx", read_idx, 0, B - 1)
    read_lens = _int32("read_lens", read_lens, B)
    reads3 = pack_rows3(reads_codes).view(np.int32)
    return (ref3,) + _tensors((word10, lane10, reads3, read_idx, read_lens),
                              device)
