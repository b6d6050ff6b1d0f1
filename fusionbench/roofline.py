"""The split-read screen's least time on the card: its work from the
candidates' shapes over the card's integer peak.

The work is the algorithm's, never an implementation's instructions: each
candidate runs two DPs (the read against flank 1, the reversed read against
reversed flank 2) of ``read_len x flank_len`` cells.  A cell of the
recurrence ``M[i][j] = max(M[i-1][j-1] + sub, M[i-1][j] + gap,
M[i][j-1] + gap)`` with its row maximum is seven integer operations as
written (a substitution select, three adds, two maxima, the row max); the
card's DPX instructions fuse an add into a max (``viaddmax``), so the
fewest operations a cell can take is three: ``CELL_OPS``.  Scores fit 16
bits, and a lane computes a 16-bit pair of cells per instruction, counted
as two operations: the peak is SMs x 64 INT32 lanes x 2 x the SM clock.
"""

from __future__ import annotations

import subprocess

import numpy as np

CELL_OPS = 3
LANES_PER_SM = 64
HALVES = 2


def screen_cells(ulen1, ulen2, ref_idx, read_lens) -> int:
    """DP cells of one screen call, from the candidates' shapes: each read's
    length times its two flanks' lengths."""
    idx = np.asarray(ref_idx, np.int64)
    flanks = np.asarray(ulen1, np.int64)[idx] + \
        np.asarray(ulen2, np.int64)[idx]
    return int((np.asarray(read_lens, np.int64) * flanks).sum())


def max_sm_clock_hz() -> float | None:
    """The card's highest SM clock as ``nvidia-smi`` reads it (the clock
    at the moment of reading is the idle one between kernels; a bound takes
    the clock the card can run at)."""
    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=clocks.max.sm",
             "--format=csv,noheader,nounits", "-i", "0"],
            capture_output=True, text=True, timeout=30, check=True).stdout
        return float(out.strip().splitlines()[0]) * 1e6
    except (OSError, subprocess.SubprocessError, ValueError, IndexError):
        return None


def int_peak_ops(sm_count: int, clock_hz: float) -> float:
    return sm_count * LANES_PER_SM * HALVES * clock_hz


def share_pct(cells: int, kernel_s: float, peak_ops: float) -> float:
    """The screen's share of its roofline, in %."""
    return 100.0 * cells * CELL_OPS / peak_ops / kernel_s
