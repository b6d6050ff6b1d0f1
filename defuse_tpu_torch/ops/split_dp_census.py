"""Instruction census of the CUDA screen, the measured issue rate of the
card, the screen's bound and its roofline.

Counterpart of ``defuse_tpu/ops/split_dp_census.py``, whose vreg census
and VPU probe price the TPU kernel.  Here:

* ``screen_bound`` is the least time the card could take for a screen's
  DP cells, from the operands alone: it does not depend on how the kernel
  is written;
* ``census_screen_ops`` counts the warp instructions one candidate costs
  ``csrc/split_dp.cu::screen_kernel<CMAX, LANES>``, by class, from the
  loop structure of ``dp_rows`` and the combine loop;
* ``issue_peak_probe`` measures what one warp instruction of each class
  costs on the card, with the kernel of ``csrc/issue_probe.cu`` (wrapper
  ``issue_probe``, plain version ``issue_probe_ref``);
* ``screen_roofline`` prices the bound and the census at those costs and
  sets the screen kernel's measured time against both;
* ``sass_loops`` reads the loop bodies of the built kernels' machine code
  (``cuobjdump -sass``), so a census that no longer describes the
  compiled kernel is caught (``census_mismatches``).

Classes: ``dpx`` is the Hopper DPX family (``VIADDMNMX``: ``max(a + b,
c)``; ``VIMNMX3``), ``shfl`` the warp shuffles, ``redux`` the warp
reductions, and ``alu`` every other integer instruction, vector or uniform
(add, multiply-add, compare, select, min/max, logic, moves).  The screen's
row loop works on both int16 halves of its registers (``.S16x2``,
``.U16x2``, ``.16x2``); the ``alu16`` and ``dpx16`` mixes price those.
"""

from __future__ import annotations

import ctypes
import re

import numpy as np
import torch

from ._build import bind, check_operand, cuda_device

CLASSES = ("alu", "dpx", "shfl", "redux")
MIXES = ("alu", "dpx", "shfl", "redux", "alu16", "dpx16")
STREAMS = 4          # chains per thread in csrc/issue_probe.cu
UNROLL = 16          # steps per trip of its rolled loop (kUnroll)
PROBE_THREADS = 256  # threads per block (kThreads)
RESIDENT_BLOCKS = 8  # blocks per SM: 2048 threads, the SM's maximum
WARP = 32
TILE_ROWS = 32       # rows between two flushes of dp_rows' row-max tile
TOLERANCE = 0.2      # census vs SASS, per class (census_mismatches)
HALF_MASK = 0x0FFF0FFF  # start bits of the 16x2 mixes' chains

# warp instructions of one probe step (all STREAMS chains), by class
MIX_STEP = {
    "alu": {"alu": 2 * STREAMS},               # max/min + add per chain
    "dpx": {"dpx": STREAMS},                   # VIADDMNMX per chain
    "shfl": {"shfl": STREAMS, "dpx": STREAMS},
    # the warp max lands in a uniform register: a move back, then the add
    "redux": {"redux": STREAMS, "alu": 2 * STREAMS},
    "alu16": {"alu": 2 * STREAMS},             # VIMNMX.S16x2 + VIADD.16x2
    "dpx16": {"dpx": STREAMS},                 # VIADDMNMX.S16x2
}
LOOP_CONTROL = {"alu": 2}  # counter add and compare, per trip

LAUNCHES = {"issue_probe": 0}


def reset_launches() -> None:
    LAUNCHES["issue_probe"] = 0


# --- the bound ---------------------------------------------------------------

# The least a DP cell costs, whatever the kernel: the substitution score,
# one add, the row max (``alu``), and the two add-max of the recurrence
# (``dpx``); values stay within +-2 * MAX_READ, so two cells fit one
# register as int16x2.
BOUND_INSTR_PER_CELL = {"alu": 3, "dpx": 2}
CELLS_PER_LANE = 2


def screen_cells(ulen1, ulen2, ref_idx, read_lens) -> int:
    """DP cells of a screen: for each candidate its read length times the
    columns of both flanks, sum of 2 DPs of n * (ref_len + 1).  Takes the
    operands of ``screen_candidates`` (tensors or arrays)."""
    l1, l2, idx, n = (np.asarray(a.cpu() if hasattr(a, "cpu") else a)
                      .astype(np.int64)
                      for a in (ulen1, ulen2, ref_idx, read_lens))
    return int((n * (l1[idx] + l2[idx] + 2)).sum())


def screen_bound_ms(cells: int, cost: dict, packed: bool = True) -> float:
    """The least milliseconds the card could take for ``cells`` DP cells:
    BOUND_INSTR_PER_CELL warp instructions per 32 lanes, two cells a lane
    when ``packed``, priced at ``cost`` (card-wide ns per warp instruction
    by class, from ``issue_peak_probe``)."""
    per_warp_instr = WARP * (CELLS_PER_LANE if packed else 1)
    ns = sum(n * cost[k] for k, n in BOUND_INSTR_PER_CELL.items())
    return cells / per_warp_instr * ns / 1e6


# --- the census --------------------------------------------------------------

def shape_for(R: int) -> tuple[int, int]:
    """``shape_for`` of ``csrc/split_dp.cu``: (lanes a candidate's group,
    most columns a lane) of the screen kernel for flank tables of width R;
    (0, 0) when R + 1 > 1024."""
    need = R + 1
    for lanes, cmax in ((8, 16), (16, 18), (32, 16), (32, 32)):
        if need <= lanes * cmax:
            return lanes, cmax
    return 0, 0


def cols_per_lane(ref_len: int, lanes: int) -> int:
    """Columns a lane of a group of ``lanes`` that holds ``ref_len + 1``
    DP columns."""
    return max(1, -(-(ref_len + 1) // lanes))


def _log2(n: int) -> int:
    return n.bit_length() - 1


def _total(items: dict) -> dict:
    total = dict.fromkeys(CLASSES, 0)
    for counts in items.values():
        for k, v in counts.items():
            total[k] += v
    return total


# (lanes, most columns a lane, C): integer instructions nvcc adds to that
# row loop beyond the itemized ones, where the kernel's largest column
# counts leave it short of registers and it recomputes addresses and moves
# values every row; read from the SASS of the screen kernels (nvcc 12.8,
# sm_90a).  The census-vs-SASS check in chip_smoke.py holds this table to
# the code.
RECOMPUTED = {(8, 16, 16): 12, (16, 18, 15): 15, (32, 16, 15): 12,
              (32, 16, 16): 18}
# the same for the row-maxima kernel's copies of the row loop, read from
# its SASS (nvcc 12.8, sm_90a)
RECOMPUTED_ROWMAX = {(8, 16, 16): 13, (16, 18, 17): 18, (32, 16, 16): 13,
                     (32, 32, 31): 26}


def row_census(C: int, lanes: int = WARP, cmax: int | None = None,
               kernel: str = "screen_kernel") -> dict:
    """Warp instructions of one DP row of ``dp_rows<C, LANES>`` by class,
    itemized as nvcc compiles each source operation for sm_90a, in
    ``kernel`` (``screen_kernel`` or ``rowmax_kernel``) built for up to
    ``cmax`` columns a lane (``RECOMPUTED`` or ``RECOMPUTED_ROWMAX``
    applies when it is given).  Memory instructions (the row's read
    characters, the tile store) and branches are left out."""
    recomputed = RECOMPUTED_ROWMAX if kernel == "rowmax_kernel" \
        else RECOMPUTED
    steps = _log2(lanes)
    items = {
        # pointer step of the row's read characters
        "read_char": {"alu": 1},
        # per column: the substitution test (VIADDMNMX.U16x2), diag + miss
        # (VIADD.16x2), min(. - 6, up) (VIADDMNMX.S16x2)
        "vertical": {"dpx": 2 * C, "alu": C},
        # the lane's min: VIMNMX3 over column pairs, a VIMNMX for the odd one
        "lane_min": {"dpx": (C - 1) // 2, "alu": 1 if C % 2 == 0 else 0},
        # min-scan across the group: shuffle and VIMNMX per step
        "scan": {"shfl": steps, "alu": steps},
        # carry into the lane: shuffle, select for the group's first lane
        "carry": {"shfl": 1, "alu": 1},
        # per column: running min (VIMNMX), row min of z + 2i (VIADDMNMX);
        # the row min's start value
        "running": {"alu": C + 1, "dpx": C},
        # the lane's column term (VIADD.16x2), the tile pointer's step
        "store": {"alu": 2},
        # row counter and tile-row counter: add and compare each
        "loop": {"alu": 4},
        # what nvcc adds: the shuffles' mask in a uniform register, a move
        "moves": {"alu": 2 + recomputed.get((lanes, cmax, C), 0)},
    }
    return {"items": items, "total": _total(items)}


def flush_census(lanes: int, rows: int = TILE_ROWS) -> dict:
    """Warp instructions of one flush of the row-max tile
    (``reduce_tile<LANES>``) over ``rows`` rows: ``static`` is what stands
    in the row loop around the reduction's own loop (kept rolled),
    ``trip`` one trip of that loop (a lane reduces one row: LANES loads,
    VIMNMX3 over pairs, a VIMNMX, back to two scores, two thresholds, the
    store), ``total`` what a flush executes."""
    static = {"alu": 6, "dpx": 0, "shfl": 0, "redux": 0}
    trip = {"alu": 20, "dpx": lanes // 2 - 1, "shfl": 0, "redux": 0}
    trips = -(-rows // lanes)
    return {"static": static, "trip": trip, "trips": trips,
            "total": {k: static[k] + trips * trip[k] for k in CLASSES}}


def census_screen_ops(R: int, L: int, read_len: int,
                      ref_len: int | None = None) -> dict:
    """Warp instructions per candidate of the screen kernel at flank table
    width R (which picks the lanes a group, ``shape_for``), read width L,
    ``read_len`` bases and flanks of ``ref_len`` bases (R when None), by
    class.  A warp runs 32 / lanes candidates at once, so a candidate is
    charged that share of each warp instruction.

    Counted: the row loop, ``min(read_len, L)`` rows (``row_census``); the
    tile flushes (``flush_census``), one per TILE_ROWS rows and one for the
    rest; the combine loop (ceil((n+1)/lanes) trips of an add, the
    threshold compare, a max, and the loop's add and compare) and its
    butterfly max (a shuffle and a max per step).  Left out: memory
    instructions, branches and convergence barriers, and the
    once-per-candidate set-up (read staging, flank loads into registers,
    index arithmetic, the output store).
    """
    lanes, cmax = shape_for(R)
    if lanes == 0:
        raise ValueError(f"flank width {R} exceeds the kernel's 1023")
    ref_len = R if ref_len is None else min(ref_len, R)
    C = cols_per_lane(ref_len, lanes)
    n = max(0, min(read_len, L))
    row = row_census(C, lanes, cmax)["total"]
    per_warp = {k: n * row[k] for k in CLASSES}
    full, rest = divmod(n, TILE_ROWS)
    for rows, times in ((TILE_ROWS, full), (rest, 1 if rest else 0)):
        flush = flush_census(lanes, rows)["total"]
        for k in CLASSES:
            per_warp[k] += times * flush[k]
    per_warp["alu"] += 5 * -(-(n + 1) // lanes) + _log2(lanes)
    per_warp["shfl"] += _log2(lanes)
    share = WARP // lanes
    per_candidate = {k: per_warp[k] / share for k in CLASSES}
    return {"R": R, "L": L, "read_len": read_len, "ref_len": ref_len,
            "lanes": lanes, "cols_per_lane": C, "rows": n,
            "candidates_per_warp": share, "per_row": row,
            "per_candidate": per_candidate,
            "warp_instructions_per_candidate": sum(per_candidate.values())}


def census_rowmax(ref_lens, read_lens, R: int, L: int) -> dict:
    """Warp instructions of ``rowmax_kernel`` over a batch, by class, from
    the census of its row loop: instances paired (2p, 2p+1) in groups of
    ``shape_for(R)`` lanes, 32 / lanes groups a warp; a warp runs its
    longest read's rows with the columns a lane of its longest flank
    (``row_census``) and flushes its tile every TILE_ROWS rows and once for
    the rest (``flush_census``).  Left out, as in ``census_screen_ops``:
    memory instructions, branches, the set-up and the output stores."""
    lanes, cmax = shape_for(R)
    if lanes == 0:
        raise ValueError(f"flank width {R} exceeds the kernel's 1023")
    per_warp = 2 * (WARP // lanes)
    flanks, reads = (np.clip(np.asarray(a, np.int64), 0, hi)
                     for a, hi in ((ref_lens, R), (read_lens, L)))
    pad = (-len(flanks)) % per_warp
    flanks, reads = (np.concatenate([a, np.zeros(pad, np.int64)])
                     .reshape(-1, per_warp) for a in (flanks, reads))
    cols = np.maximum(1, -(-(flanks.max(axis=1) + 1) // lanes))
    rows = reads.max(axis=1)
    total = dict.fromkeys(CLASSES, 0)
    shapes, counts = np.unique(np.stack([cols, rows], axis=1), axis=0,
                               return_counts=True)
    for (C, n), times in zip(shapes.tolist(), counts.tolist()):
        row = row_census(C, lanes, cmax, "rowmax_kernel")["total"]
        full, rest = divmod(n, TILE_ROWS)
        flush = flush_census(lanes)["total"]
        tail = flush_census(lanes, rest)["total"] if rest else {}
        for k in CLASSES:
            total[k] += times * (n * row[k] + full * flush[k]
                                 + tail.get(k, 0))
    return {"lanes": lanes, "warps": int(len(cols)), "instructions": total}


def census_ms(instructions: dict, cost: dict) -> float:
    """Milliseconds of ``instructions`` (warp instructions by class) at
    ``cost`` (card-wide ns per warp instruction by class): the time the
    card takes to issue them if no two classes share a cycle."""
    return sum(n * cost[k] for k, n in instructions.items()) / 1e6


def mix_census(mix: str) -> dict:
    """Warp instructions of one trip of the probe's rolled loop: UNROLL
    steps of ``mix`` and the loop's control."""
    trip = {k: UNROLL * MIX_STEP[mix].get(k, 0) + LOOP_CONTROL.get(k, 0)
            for k in CLASSES}
    return trip


# --- the probe ---------------------------------------------------------------

def issue_probe_ref(seed, iters: int, mix: str):
    """Plain version of the probe: each thread's max over its STREAMS
    chains after ``iters`` steps of ``mix``, from ``seed[t] + s``.
    ``seed`` (N,) int32, N a multiple of 32 (threads in lane order)."""
    start = seed.to(torch.int32)
    if mix in ("alu16", "dpx16"):
        return _probe16_ref(start & HALF_MASK, iters, mix)
    a = start[:, None] + torch.arange(
        STREAMS, dtype=torch.int32, device=seed.device)
    lane = (torch.arange(seed.shape[0], device=seed.device) % WARP) \
        .to(torch.int32)[:, None]
    one, two = (torch.tensor(v, dtype=torch.int32, device=seed.device)
                for v in (1, 2))
    for _ in range(iters):
        x, y = a[:, 0::2], a[:, 1::2]
        if mix == "alu":
            a = _interleave(torch.maximum(x, y) + one,
                            torch.minimum(x, y) + two)
        elif mix == "dpx":
            a = _interleave(torch.maximum(x + one, y),
                            torch.maximum(y + two, x))
        elif mix == "shfl":
            w = a.view(-1, WARP, STREAMS)
            up = torch.cat([w[:, :1], w[:, :-1]], dim=1).reshape(a.shape)
            a = torch.maximum(a + one, up)
        elif mix == "redux":
            w = (a + lane).view(-1, WARP, STREAMS)
            a = w.amax(dim=1, keepdim=True).expand_as(w).reshape(a.shape)
        else:
            raise ValueError(f"mix {mix!r}: one of {MIXES}")
    return a.amax(dim=1)


def _interleave(even, odd):
    return torch.stack([even, odd], dim=2).reshape(even.shape[0], -1)


def _wrap16(v):
    """Two's-complement wrap of int32 values into int16's range."""
    return ((v + 32768) & 0xFFFF) - 32768


def _probe16_ref(start, iters: int, mix: str):
    """The 16x2 mixes: the ``alu`` and ``dpx`` steps on each int16 half
    of the chains (wrapping, as ``VIADD.16x2`` does), from ``start + s``;
    returns the int32 max of each thread's packed chains."""
    a = start[:, None] + torch.arange(STREAMS, dtype=torch.int32,
                                      device=start.device)
    halves = [_wrap16(a & 0xFFFF), a >> 16]
    for _ in range(iters):
        for h, v in enumerate(halves):
            x, y = v[:, 0::2], v[:, 1::2]
            if mix == "alu16":
                v = _interleave(torch.maximum(x, y) + 1,
                                torch.minimum(x, y) + 2)
            else:
                v = _interleave(torch.maximum(_wrap16(x + 1), y),
                                torch.maximum(_wrap16(y + 2), x))
            halves[h] = _wrap16(v)
    lo, hi = halves
    return ((hi << 16) | (lo & 0xFFFF)).amax(dim=1)


_SIGS = {"issue_probe": [ctypes.c_void_p, ctypes.c_int, ctypes.c_int,
                         ctypes.c_void_p, ctypes.c_int, ctypes.c_void_p]}


def issue_probe(seed, iters: int, mix: str):
    """The probe kernel on ``seed``'s CUDA device (its plain version for a
    CPU tensor): (N,) int32, N a multiple of 256, ``iters`` a multiple of
    UNROLL."""
    if mix not in MIXES:
        raise ValueError(f"mix {mix!r}: one of {MIXES}")
    if seed.device.type == "cpu":
        return issue_probe_ref(seed, iters, mix)
    dev = cuda_device(seed, "issue-probe")
    check_operand("seed", seed, torch.int32, 1, dev)
    n = seed.shape[0]
    if n % PROBE_THREADS or iters % UNROLL or iters < 0:
        raise ValueError(f"seed length {n} must be a multiple of "
                         f"{PROBE_THREADS} and iters {iters} of {UNROLL}")
    out = torch.empty_like(seed)
    with torch.cuda.device(dev):
        err = bind("issue_probe", _SIGS).issue_probe(
            seed.data_ptr(), iters, MIXES.index(mix), out.data_ptr(),
            n // PROBE_THREADS, torch.cuda.current_stream().cuda_stream)
    if err != 0:
        raise RuntimeError(f"issue_probe launch failed: CUDA error {err}")
    LAUNCHES["issue_probe"] += 1
    return out


def probe_seed(device) -> torch.Tensor:
    """Seeded start values for a full card: RESIDENT_BLOCKS blocks of
    PROBE_THREADS on every SM."""
    sms = torch.cuda.get_device_properties(device).multi_processor_count
    n = sms * RESIDENT_BLOCKS * PROBE_THREADS
    rng = np.random.default_rng(0)
    return torch.from_numpy(rng.integers(0, 1 << 20, n).astype(np.int32)) \
        .to(device)


PROBE_ITERS = (1 << 12, 1 << 15)  # the two step counts of the probe
PROBE_REPS = 5


def issue_peak_probe(device="cuda") -> dict:
    """Measured cost of one warp instruction of each class on the card.

    Times each mix at the two step counts of PROBE_ITERS over a full card
    of resident warps and takes the marginal time of a step, so launch
    and set-up cancel.
    A step's warp instructions (``MIX_STEP`` times the warps) give each
    mix's cost per warp instruction.  Per class: ``alu`` and ``dpx`` from
    their own mixes; ``shfl`` and ``redux`` from theirs after their dpx or
    alu share is taken out at the measured price (the reference's
    subtraction), but never below the cheaper of those two, one issue
    slot.  ``ns_per_warp_instr_16x2`` prices the same classes for code
    that works on int16 halves: ``alu`` and ``dpx`` from the ``alu16`` and
    ``dpx16`` mixes, shuffles and reductions as above.  Costs are
    card-wide nanoseconds per warp instruction."""
    from ..core.devices import require_cuda
    from ..utils.profiling import cuda_time_ms
    dev = require_cuda(device)
    if dev.type != "cuda":
        raise ValueError("the issue-rate probe measures a CUDA device")
    seed = probe_seed(dev)
    warps = seed.shape[0] // WARP
    small, big = PROBE_ITERS
    out = {"threads": seed.shape[0], "warps": warps, "streams": STREAMS,
           "iters": list(PROBE_ITERS), "mixes": {}}
    step_ns = {}
    for mix in MIXES:
        t_small, t_big = [
            cuda_time_ms(lambda: issue_probe(seed, n, mix), PROBE_REPS)
            for n in PROBE_ITERS]
        step_ns[mix] = (t_big - t_small) * 1e6 / (big - small)
        instr = warps * sum(MIX_STEP[mix].values())
        out["mixes"][mix] = {
            "t_small_ms": t_small, "t_big_ms": t_big,
            "ns_per_step": step_ns[mix],
            "ns_per_warp_instr": step_ns[mix] / instr,
            "warp_instr_per_ns": instr / step_ns[mix]}
    c_alu = step_ns["alu"] / (warps * MIX_STEP["alu"]["alu"])
    c_dpx = step_ns["dpx"] / (warps * MIX_STEP["dpx"]["dpx"])
    floor = min(c_alu, c_dpx)
    c_shfl = (step_ns["shfl"] / warps
              - MIX_STEP["shfl"]["dpx"] * c_dpx) / STREAMS
    c_redux = (step_ns["redux"] / warps
               - MIX_STEP["redux"]["alu"] * c_alu) / STREAMS
    out["ns_per_warp_instr"] = {"alu": c_alu, "dpx": c_dpx,
                                "shfl": max(c_shfl, floor),
                                "redux": max(c_redux, floor)}
    out["ns_per_warp_instr_16x2"] = dict(
        out["ns_per_warp_instr"],
        alu=step_ns["alu16"] / (warps * MIX_STEP["alu16"]["alu"]),
        dpx=step_ns["dpx16"] / (warps * MIX_STEP["dpx16"]["dpx"]))
    return out


# --- the roofline ------------------------------------------------------------

ROOF_R, ROOF_L, ROOF_READ = 256, 64, 50
ROOF_BATCHES = (16_384, 65_536)
ROOF_FLANKS = 4096


def roofline_operands(device):
    """The roofline shape's screen operands on ``device``: flanks of R = 256
    bases (4,096 seeded ones, gathered by a seeded ``ref_idx``), reads of
    50 random bases in an L = 64 matrix, 65,536 candidates."""
    from ..convert import screen_min_scores, screen_operands
    rng = np.random.default_rng(0)
    acgt = np.frombuffer(b"ACGT", dtype=np.uint8)
    B = ROOF_BATCHES[-1]
    flanks = acgt[rng.integers(0, 4, (2, ROOF_FLANKS, ROOF_R))]
    flank_lens = np.full(ROOF_FLANKS, ROOF_R, np.int32)
    reads = np.zeros((B, ROOF_L), np.uint8)
    reads[:, :ROOF_READ] = acgt[rng.integers(0, 4, (B, ROOF_READ))]
    read_lens = np.full(B, ROOF_READ, np.int32)
    return screen_operands(flanks[0], flank_lens, flanks[1], flank_lens,
                           rng.integers(0, ROOF_FLANKS, B), reads, read_lens,
                           screen_min_scores(read_lens), device)


def screen_roofline(device="cuda", probe: dict | None = None) -> dict:
    """The screen kernel's marginal time per candidate against its bound
    and against the census, both priced at the probe's measured costs.

    Shape of ``bench.py``'s split-DP microbench (``roofline_operands``),
    at B = 16,384 and 65,536 candidates; the marginal between the two
    batches cancels launch costs.  ``bound_us_per_read`` is
    ``screen_bound_ms`` of a candidate's cells (``pct_of_bound`` = bound /
    measured; ``bound32_us_per_read`` the same without packing two cells
    a register).  ``ceiling_us_per_read`` prices the kernel's own census
    (it assumes no two classes issue in the same cycle; ``pct_of_ceiling``
    = ceiling / measured): a diagnostic of how well the kernel's stream
    issues, not of how short it is.  ``probe`` passes an
    ``issue_peak_probe`` result taken earlier in the run."""
    from ..core.devices import require_cuda
    from ..utils.profiling import cuda_time_ms
    from .split_dp_cuda import screen_candidates
    dev = require_cuda(device)
    if dev.type != "cuda":
        raise ValueError("the roofline measures a CUDA device")
    ops = roofline_operands(dev)
    times = []
    for b in ROOF_BATCHES:
        sub = ops[:4] + tuple(a[:b] for a in ops[4:])
        times.append(cuda_time_ms(lambda: screen_candidates(*sub), 10))
    measured_us = (times[1] - times[0]) * 1e3 / \
        (ROOF_BATCHES[1] - ROOF_BATCHES[0])
    census = census_screen_ops(ROOF_R, ROOF_L, ROOF_READ)
    if probe is None:
        probe = issue_peak_probe(dev)
    cost = probe["ns_per_warp_instr_16x2"]
    ceiling_us = sum(census["per_candidate"][k] * cost[k]
                     for k in CLASSES) / 1e3
    cells = 2 * ROOF_READ * (ROOF_R + 1)
    bound_us = screen_bound_ms(cells, cost) * 1e3
    bound32_us = screen_bound_ms(cells, probe["ns_per_warp_instr"],
                                 packed=False) * 1e3
    return {"R": ROOF_R, "L": ROOF_L, "read_len": ROOF_READ,
            "batches": list(ROOF_BATCHES), "batch_ms": times,
            "measured_us_per_read": measured_us,
            "cells_per_read": cells,
            "bound_us_per_read": bound_us,
            "bound32_us_per_read": bound32_us,
            "pct_of_bound": 100.0 * bound_us / measured_us,
            "ceiling_us_per_read": ceiling_us,
            "pct_of_ceiling": 100.0 * ceiling_us / measured_us,
            "census": census, "ns_per_warp_instr": cost, "probe": probe}


# --- machine code ------------------------------------------------------------

_CONTROL = {"BRA", "BRX", "JMP", "JMX", "CALL", "RET", "EXIT", "BSSY",
            "BSYNC", "BREAK", "BMOV", "WARPSYNC", "NOP", "YIELD", "BAR",
            "DEPBAR", "KILL"}
_DPX = {"VIADDMNMX", "VIMNMX3", "VIBMNMX"}
_MEM = ("LD", "ST", "ULD", "ATOM", "RED", "CCTL", "MEMBAR", "FENCE")

_FUNC = re.compile(r"Function\s*:\s*(\S+)")
_INSTR = re.compile(r"/\*([0-9a-f]{4,})\*/\s+(.*?)\s*;")
_LABEL = re.compile(r"^\s*(\.L_x_\d+):")
_GUARD = re.compile(r"^@!?U?P[T0-9]+\s+")
_TARGET = re.compile(r"(0x[0-9a-f]+|\.L_x_\d+)")


def sass_class(opcode: str) -> str:
    """Class of a SASS opcode: one of CLASSES, or ``mem``/``control``."""
    base = opcode.split(".")[0]
    if base == "SHFL":
        return "shfl"
    if base == "REDUX":
        return "redux"
    if base in _DPX:
        return "dpx"
    if base in _CONTROL:
        return "control"
    if base.startswith(_MEM):
        return "mem"
    return "alu"


def sass_loops(text: str, innermost: bool = True) -> dict:
    """Loops of each function in ``cuobjdump -sass`` output:
    ``{function: [{"start", "end", "counts": {class: n}, "opcodes",
    "nested"}]}`` in address order.  A loop is the address range from a
    backward branch's target to the branch.  With ``innermost`` only the
    loops that hold no other loop; else every loop, counted without the
    instructions of the ``nested`` loops inside it."""
    funcs: dict[str, list] = {}
    name = None
    pending_labels: list[str] = []
    labels: dict[str, dict] = {}
    for line in text.splitlines():
        m = _FUNC.search(line)
        if m:
            name = m.group(1)
            funcs[name] = []
            labels[name] = {}
            continue
        m = _LABEL.match(line)
        if m and name is not None:
            pending_labels.append(m.group(1))
            continue
        m = _INSTR.search(line)
        if m and name is not None:
            addr = int(m.group(1), 16)
            for lab in pending_labels:
                labels[name][lab] = addr
            pending_labels = []
            funcs[name].append((addr, _GUARD.sub("", m.group(2))))
    out = {}
    for name, instrs in funcs.items():
        loops = set()
        for addr, ins in instrs:
            op = ins.split()[0]
            if op.split(".")[0] != "BRA":
                continue
            targets = _TARGET.findall(ins[len(op):])
            if not targets:
                continue
            t = targets[-1]
            dest = labels[name].get(t) if t.startswith(".L") else int(t, 16)
            if dest is not None and dest <= addr:
                loops.add((dest, addr))
        found = []
        for start, end in sorted(loops):
            inside = [o for o in loops if o != (start, end)
                      and start <= o[0] and o[1] <= end]
            if innermost and inside:
                continue
            counts = dict.fromkeys(CLASSES + ("mem", "control"), 0)
            opcodes: dict[str, int] = {}
            for addr, ins in instrs:
                if start <= addr <= end and not any(
                        o[0] <= addr <= o[1] for o in inside):
                    op = ins.split()[0]
                    counts[sass_class(op)] += 1
                    opcodes[op.split(".")[0]] = \
                        opcodes.get(op.split(".")[0], 0) + 1
            found.append({"start": start, "end": end, "counts": counts,
                          "opcodes": opcodes, "nested": len(inside)})
        out[name] = found
    return out


def row_loops(text: str, kernel: str = "screen_kernel") -> dict:
    """The row loops of each ``<kernel><CMAX, LANES>`` (``screen_kernel``
    or ``rowmax_kernel``, which run the same ``dp_rows``), one per column
    count C of its switch: ``{(lanes, cmax): {C: loop}}``.  A row loop is a
    loop with warp shuffles outside its nested loops (the tile flush's
    reduction); its ``per_row`` counts leave the nested loops out.  The
    scan's shuffles (log2(lanes) + 1 a row) give the rows per trip, and
    the three ``VIADDMNMX`` a column give C."""
    out: dict[tuple, dict] = {}
    for name, loops in sass_loops(text, innermost=False).items():
        m = re.search(rf"{kernel}ILi(\d+)ELi(\d+)E", name)
        if not m:
            continue
        cmax, lanes = int(m.group(1)), int(m.group(2))
        rows = out.setdefault((lanes, cmax), {})
        for lp in loops:
            shfl = lp["counts"]["shfl"]
            per_trip, odd = divmod(shfl, _log2(lanes) + 1)
            if not shfl or odd:
                continue
            C, odd = divmod(lp["opcodes"].get("VIADDMNMX", 0), 3 * per_trip)
            if odd or not C:
                continue
            rows[C] = dict(lp, rows_per_trip=per_trip, per_row={
                k: lp["counts"][k] / per_trip for k in CLASSES})
    return out


def probe_loops(text: str) -> dict:
    """The rolled step loop of each probe mix: ``{mix: loop}``."""
    out = {}
    for name, loops in sass_loops(text).items():
        m = re.search(r"probe_kernelILi(\d+)E", name)
        if m and loops:
            out[MIXES[int(m.group(1))]] = max(
                loops, key=lambda lp: sum(lp["counts"].values()))
    return out


def census_mismatches(census: dict, sass_counts: dict) -> list[str]:
    """Classes whose SASS count differs from the census by more than
    TOLERANCE of the census count or one instruction, whichever is
    larger; an empty list when the census describes the code."""
    bad = []
    for k in CLASSES:
        want, got = census.get(k, 0), sass_counts.get(k, 0)
        if abs(got - want) > max(TOLERANCE * want, 1):
            bad.append(f"{k}: census {want:g}, SASS {got:g}")
    return bad
