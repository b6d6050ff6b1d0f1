"""Split-read DP on the card: wrappers around ``csrc/split_dp.cu``.

Counterpart of ``defuse_tpu/ops/split_dp_pallas.py`` and of the XLA
program ``defuse_tpu/ops/split_dp_batch.py::dp_tie_columns``.  Three
entries:

* ``dp_row_maxima_cuda`` — rowmax (B, L+1) int32 for per-instance flanks,
  like ``dp_row_maxima_pallas``; two instances share a lane group of as
  many lanes as the screen gives the table's width;
* ``dp_tie_columns_cuda`` — for the rows each instance selects, the
  anchored row max and the bit-packed columns that reach it, like
  ``dp_tie_columns``; the DP runs only to the largest row a warp selects;
* ``screen_candidates`` — the fused candidate screen, like
  ``screen_candidates_pallas``: one launch gathers the flanks by
  ``ref_idx`` from the uint8 unique-flank tables, reverses each read by
  index arithmetic, runs both DPs side by side in the int16 halves of its
  registers, combines, thresholds and writes only the (B,) int32 max
  scores (0 = reject).  The table's width picks how many lanes a candidate
  gets (``csrc/split_dp.cu::shape_for``); each warp takes the columns its
  own flanks need.

Inputs are uint8 character codes (0 = pad) and int32 lengths, indices
and thresholds, contiguous.  A tensor on the CPU goes to the plain version
in ``ops/split_dp_batch.py``; a CUDA tensor launches the kernel or raises.
``LAUNCHES`` counts kernel launches per entry.
"""

from __future__ import annotations

import ctypes

import torch

from ..align.split_dp import GAP, MATCH, MIN_SPLIT_SCORE, MISMATCH

from . import split_dp_batch
from ._build import bind, check_operand, cuda_device

MAX_COLS = 1024  # R+1 bound: 32 lanes x 32 columns in registers
MAX_READ = 1024  # L bound: DP values stay inside int16 (+-2 * MAX_READ * 3)

LAUNCHES = {"split_dp_rowmax": 0, "split_dp_screen": 0,
            "split_dp_tie_columns": 0}

_P = ctypes.c_void_p
_I = ctypes.c_int
_SIGS = {
    "split_dp_rowmax": [_P, _P, _I, _P, _P, _I, _P, _I, _I, _I, _I, _I, _P],
    "split_dp_tie_columns": [_P, _P, _I, _P, _I, _P, _I, _P, _P, _I, _I, _I,
                             _I, _I, _P],
    "split_dp_screen": [_P, _P, _P, _P, _I, _P, _P, _P, _I, _P, _P, _I,
                        _I, _I, _I, _I, _P],
}


def reset_launches() -> None:
    for name in LAUNCHES:
        LAUNCHES[name] = 0


def _check_widths(R: int, L: int) -> None:
    if R + 1 > MAX_COLS:
        raise ValueError(f"flank width {R} exceeds the kernel's "
                         f"{MAX_COLS - 1}")
    if L > MAX_READ:
        raise ValueError(f"read width {L} exceeds the kernel's {MAX_READ}")


def _launch(name: str, *args) -> None:
    fn = getattr(bind("split_dp", _SIGS), name)
    stream = torch.cuda.current_stream().cuda_stream
    err = fn(*args, MATCH, MISMATCH, GAP, MIN_SPLIT_SCORE, stream)
    if err != 0:
        raise RuntimeError(f"{name} launch failed: CUDA error {err}")
    LAUNCHES[name] += 1


def _instances(refs, ref_lens, reads, read_lens):
    """Check the per-instance operands on their CUDA device; (device, B, R,
    L)."""
    dev = cuda_device(refs, "split-DP")
    check_operand("refs", refs, torch.uint8, 2, dev)
    check_operand("ref_lens", ref_lens, torch.int32, 1, dev)
    check_operand("reads", reads, torch.uint8, 2, dev)
    check_operand("read_lens", read_lens, torch.int32, 1, dev)
    B, R = refs.shape
    L = reads.shape[1]
    if reads.shape[0] != B or ref_lens.shape[0] != B \
            or read_lens.shape[0] != B:
        raise ValueError("batch sizes differ")
    _check_widths(R, L)
    return dev, B, R, L


def dp_row_maxima_cuda(refs, ref_lens, reads, read_lens):
    """rowmax (B, L+1) int32 of the split DP; see
    ``split_dp_batch.dp_row_maxima``."""
    if refs.device.type == "cpu":
        return split_dp_batch.dp_row_maxima(refs, ref_lens, reads, read_lens)
    dev, B, R, L = _instances(refs, ref_lens, reads, read_lens)
    out = torch.empty((B, L + 1), dtype=torch.int32, device=dev)
    if B:
        with torch.cuda.device(dev):
            _launch("split_dp_rowmax", refs.data_ptr(), ref_lens.data_ptr(),
                    R, reads.data_ptr(), read_lens.data_ptr(), L,
                    out.data_ptr(), B)
    return out


def dp_tie_columns_cuda(refs, ref_lens, reads, read_lens, row_sel):
    """(rowmax (B, M) int32, packed (B, M, ceil((R+1)/32)) int32) of the
    rows ``row_sel`` (B, M) int32 selects; see
    ``split_dp_batch.dp_tie_columns``, whose bytes it returns.  Rows read
    the characters of ``reads`` as stored, pad included, as the plain
    version does, so the kernel has no use for ``read_lens``."""
    if refs.device.type == "cpu":
        return split_dp_batch.dp_tie_columns(refs, ref_lens, reads,
                                             read_lens, row_sel)
    dev, B, R, L = _instances(refs, ref_lens, reads, read_lens)
    check_operand("row_sel", row_sel, torch.int32, 2, dev)
    if row_sel.shape[0] != B:
        raise ValueError("row_sel: batch sizes differ")
    M = row_sel.shape[1]
    W = (R + 1 + 31) // 32
    rowmax = torch.empty((B, M), dtype=torch.int32, device=dev)
    packed = torch.empty((B, M, W), dtype=torch.int32, device=dev)
    if B and M:
        with torch.cuda.device(dev):
            _launch("split_dp_tie_columns", refs.data_ptr(),
                    ref_lens.data_ptr(), R, reads.data_ptr(), L,
                    row_sel.data_ptr(), M, rowmax.data_ptr(),
                    packed.data_ptr(), B)
    return rowmax, packed


def screen_candidates(uref1, ulen1, uref2r, ulen2, ref_idx, reads,
                      read_lens, min_scores):
    """Per-candidate max split score (0 = reject) in one launch.

    uref1/uref2r (U, R) uint8 unique flanks (the second reversed), ulen1/
    ulen2 (U,), ref_idx (B,) in [0, U), reads (B, L) uint8, read_lens and
    min_scores (B,), all int32 where not uint8.  The kernel trusts
    ``ref_idx`` and the lengths to be in range; ``convert.screen_operands``
    checks them on the host.
    """
    if reads.device.type == "cpu":
        return split_dp_batch.screen_candidates_ref(
            uref1, ulen1, uref2r, ulen2, ref_idx, reads, read_lens,
            min_scores)
    dev = cuda_device(reads, "split-DP")
    check_operand("uref1", uref1, torch.uint8, 2, dev)
    check_operand("uref2r", uref2r, torch.uint8, 2, dev)
    check_operand("reads", reads, torch.uint8, 2, dev)
    for name, t in (("ulen1", ulen1), ("ulen2", ulen2), ("ref_idx", ref_idx),
                    ("read_lens", read_lens), ("min_scores", min_scores)):
        check_operand(name, t, torch.int32, 1, dev)
    B, L = reads.shape
    U, R = uref1.shape
    if tuple(uref2r.shape) != (U, R) or ulen1.shape[0] != U \
            or ulen2.shape[0] != U:
        raise ValueError("unique-flank tables differ in shape")
    if ref_idx.shape[0] != B or read_lens.shape[0] != B \
            or min_scores.shape[0] != B:
        raise ValueError("batch sizes differ")
    _check_widths(R, L)
    out = torch.empty(B, dtype=torch.int32, device=dev)
    if B:
        with torch.cuda.device(dev):
            _launch("split_dp_screen", uref1.data_ptr(), ulen1.data_ptr(),
                    uref2r.data_ptr(), ulen2.data_ptr(), R,
                    ref_idx.data_ptr(), reads.data_ptr(),
                    read_lens.data_ptr(), L, min_scores.data_ptr(),
                    out.data_ptr(), B)
    return out
