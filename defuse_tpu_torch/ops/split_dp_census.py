"""Instruction census of the CUDA screen, the measured issue rate of the
card, and the screen's roofline.

Counterpart of ``defuse_tpu/ops/split_dp_census.py``, whose vreg census
and VPU probe price the TPU kernel.  Here:

* ``census_screen_ops`` counts the warp instructions one candidate costs
  ``csrc/split_dp.cu::screen_kernel<C>``, by class, from the loop
  structure of ``dp_instance`` and the combine loop;
* ``issue_peak_probe`` measures what one warp instruction of each class
  costs on the card, with the kernel of ``csrc/issue_probe.cu`` (wrapper
  ``issue_probe``, plain version ``issue_probe_ref``);
* ``screen_roofline`` prices the census at those costs and sets the
  screen kernel's measured time against it;
* ``sass_loops`` reads the loop bodies of the built kernels' machine code
  (``cuobjdump -sass``), so a census that no longer describes the
  compiled kernel is caught (``census_mismatches``).

Classes: ``dpx`` is the Hopper DPX ``VIADDMNMX`` (``max(a + b, c)``),
``shfl`` the warp shuffles, ``redux`` the warp reductions, and ``alu``
every other integer instruction, vector or uniform (add, multiply-add,
compare, select, min/max, logic, moves).
"""

from __future__ import annotations

import ctypes
import re

import numpy as np
import torch

from ._build import bind, check_operand, cuda_device

CLASSES = ("alu", "dpx", "shfl", "redux")
MIXES = ("alu", "dpx", "shfl", "redux")
STREAMS = 4          # chains per thread in csrc/issue_probe.cu
UNROLL = 16          # steps per trip of its rolled loop (kUnroll)
PROBE_THREADS = 256  # threads per block (kThreads)
RESIDENT_BLOCKS = 8  # blocks per SM: 2048 threads, the SM's maximum
WARP = 32
SCAN_STEPS = 5       # log2(WARP): the chunk-tail scan of dp_instance
TOLERANCE = 0.2      # census vs SASS, per class (census_mismatches)

# warp instructions of one probe step (all STREAMS chains), by class
MIX_STEP = {
    "alu": {"alu": 2 * STREAMS},               # max/min + add per chain
    "dpx": {"dpx": STREAMS},                   # VIADDMNMX per chain
    "shfl": {"shfl": STREAMS, "dpx": STREAMS},
    # the warp max lands in a uniform register: a move back, then the add
    "redux": {"redux": STREAMS, "alu": 2 * STREAMS},
}
LOOP_CONTROL = {"alu": 2}  # counter add and compare, per trip

LAUNCHES = {"issue_probe": 0}


def reset_launches() -> None:
    LAUNCHES["issue_probe"] = 0


def cols_per_lane(R: int) -> int:
    """``split_dp_cols_per_lane``: the smallest C in {4, 8, 16, 32} with
    32 * C >= R + 1, or 0 when R + 1 > 1024."""
    for c in (4, 8, 16, 32):
        if WARP * c >= R + 1:
            return c
    return 0


# (C, reversed) row loops in which nvcc recomputes the column-valid tests
# every row and saves them to a register (LOP3 column index, ISETP, P2R per
# column), read from the SASS of screen_kernel<C> (nvcc 12.8, sm_90a); the
# census-vs-SASS check in chip_smoke.py holds this table to the code
PREDICATE_RECOMPUTE = {(16, True)}


def row_census(C: int, reverse: bool = False) -> dict:
    """Warp instructions of one DP row of ``dp_instance<C, REVERSE>``
    (``split_dp.cu:66-100``), by class, itemized as nvcc compiles each
    source operation for sm_90a.  The two directions run the same source
    but for the read index (``read[n - j]`` or ``read[j - 1]``); nvcc
    compiles one of them with the column tests recomputed every row
    (``PREDICATE_RECOMPUTE``)."""
    items = {
        # read character index
        "read_index": {"alu": 1},
        # previous row's last column from the lane to the left
        "diagonal": {"shfl": 1},
        # per column: rc == ch compare, select MATCH/MISMATCH, prev + GAP,
        # then max(diag + sub, ...) as one VIADDMNMX
        "vertical": {"alu": 3 * C, "dpx": C},
        # lane 0's boundary column GAP * j: multiply, select
        "boundary": {"alu": 2},
        # serial gap chain over columns 1..C-1: add, then VIMNMX (nvcc
        # keeps this dependent chain as two instructions)
        "horizontal": {"alu": 2 * (C - 1)},
        # 5-step log-scan of chunk tails: shuffle, then add, compare
        # (lane >= d and the max) and select
        "scan": {"shfl": SCAN_STEPS, "alu": 3 * SCAN_STEPS},
        # carry into the chunk: shuffle, add, select for lane 0
        "carry": {"shfl": 1, "alu": 2},
        # max(prev, carry + GAP * c) as one VIADDMNMX per column
        "carry_in": {"dpx": C},
        # row max over valid columns: compare column <= ref_len, compare
        # with the running best, select; per column
        "row_max": {"alu": 3 * C},
        # warp max, then the MIN_SPLIT_SCORE threshold: compare, select
        "reduce": {"redux": 1, "alu": 2},
        # row counter: add, compare
        "loop": {"alu": 2},
        # what nvcc adds in every row loop: the warp max moved out of its
        # uniform register, lane-bit tests, a predicate save, the shuffle
        # mask, pointer steps
        "moves": {"alu": 8},
    }
    if (C, reverse) in PREDICATE_RECOMPUTE:
        items["column_tests"] = {"alu": 3 * (C - 1)}
    total = dict.fromkeys(CLASSES, 0)
    for counts in items.values():
        for k, v in counts.items():
            total[k] += v
    return {"items": items, "total": total}


def census_screen_ops(R: int, L: int, read_len: int) -> dict:
    """Warp instructions per candidate of ``screen_kernel<C>`` at flank
    width R (C = ``cols_per_lane(R)``), read width L and ``read_len``
    bases, by class.

    Counted: both DPs' row loops, ``min(read_len, L)`` rows each (the
    itemization of ``row_census``), and the combine loop
    (``split_dp.cu:165-169``: ceil((n+1)/32) trips of an add, the
    threshold compare, a max, and the loop's add and compare; then one
    warp max).  Left out: memory instructions (the shared-memory loads
    of the read character and stores of ``rm[j]``, the combine loop's two
    loads), branches and convergence barriers, and the once-per-candidate
    set-up (read staging, flank loads into registers, index arithmetic,
    the output store).
    """
    C = cols_per_lane(R)
    if C == 0:
        raise ValueError(f"flank width {R} exceeds the kernel's 1023")
    n = max(0, min(read_len, L))
    rows = {d: row_census(C, d == "reversed")["total"]
            for d in ("forward", "reversed")}
    combine_trips = -(-(n + 1) // WARP)
    per_candidate = {k: n * (rows["forward"][k] + rows["reversed"][k])
                     for k in CLASSES}
    per_candidate["alu"] += 5 * combine_trips
    per_candidate["redux"] += 1
    return {"R": R, "L": L, "read_len": read_len, "cols_per_lane": C,
            "rows": 2 * n, "per_row": rows, "per_candidate": per_candidate,
            "warp_instructions_per_candidate": sum(per_candidate.values())}


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
    a = seed.to(torch.int32)[:, None] + torch.arange(
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
    slot.  Costs are card-wide nanoseconds per warp instruction."""
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
    return out


# --- the roofline ------------------------------------------------------------

ROOF_R, ROOF_L, ROOF_READ = 256, 64, 50
ROOF_BATCHES = (16_384, 65_536)
ROOF_FLANKS = 4096


def screen_roofline(device="cuda") -> dict:
    """The screen kernel's marginal time per candidate against the census
    priced at the probe's measured costs.

    Shape of ``bench.py``'s split-DP microbench: flanks of R = 256 bases
    (4,096 seeded ones, gathered by a seeded ``ref_idx``), reads of 50
    random bases in an L = 64 matrix, B = 16,384 and 65,536 candidates;
    the marginal between the two batches cancels launch costs.  The
    ceiling adds the classes' costs (it assumes no two classes issue in
    the same cycle); ``pct_of_ceiling`` is ceiling / measured."""
    from ..convert import screen_min_scores, screen_operands
    from ..core.devices import require_cuda
    from ..utils.profiling import cuda_time_ms
    from .split_dp_cuda import screen_candidates
    dev = require_cuda(device)
    if dev.type != "cuda":
        raise ValueError("the roofline measures a CUDA device")
    rng = np.random.default_rng(0)
    acgt = np.frombuffer(b"ACGT", dtype=np.uint8)
    B = ROOF_BATCHES[-1]
    flanks = acgt[rng.integers(0, 4, (2, ROOF_FLANKS, ROOF_R))]
    flank_lens = np.full(ROOF_FLANKS, ROOF_R, np.int32)
    reads = np.zeros((B, ROOF_L), np.uint8)
    reads[:, :ROOF_READ] = acgt[rng.integers(0, 4, (B, ROOF_READ))]
    read_lens = np.full(B, ROOF_READ, np.int32)
    ops = screen_operands(flanks[0], flank_lens, flanks[1], flank_lens,
                          rng.integers(0, ROOF_FLANKS, B), reads, read_lens,
                          screen_min_scores(read_lens), dev)
    times = []
    for b in ROOF_BATCHES:
        sub = ops[:4] + tuple(a[:b] for a in ops[4:])
        times.append(cuda_time_ms(lambda: screen_candidates(*sub), 10))
    measured_us = (times[1] - times[0]) * 1e3 / \
        (ROOF_BATCHES[1] - ROOF_BATCHES[0])
    census = census_screen_ops(ROOF_R, ROOF_L, ROOF_READ)
    probe = issue_peak_probe(dev)
    cost = probe["ns_per_warp_instr"]
    ceiling_us = sum(census["per_candidate"][k] * cost[k]
                     for k in CLASSES) / 1e3
    return {"R": ROOF_R, "L": ROOF_L, "read_len": ROOF_READ,
            "batches": list(ROOF_BATCHES), "batch_ms": times,
            "measured_us_per_read": measured_us,
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


def sass_loops(text: str) -> dict:
    """Innermost loops of each function in ``cuobjdump -sass`` output:
    ``{function: [{"start", "end", "counts": {class: n}, "opcodes"}]}``
    in address order.  A loop is the address range from a backward
    branch's target to the branch; innermost means no other loop lies
    inside it."""
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
        loops = []
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
                loops.append((dest, addr))
        inner = [lp for lp in loops if not any(
            o != lp and lp[0] <= o[0] and o[1] <= lp[1] for o in loops)]
        found = []
        for start, end in sorted(set(inner)):
            counts = dict.fromkeys(CLASSES + ("mem", "control"), 0)
            opcodes: dict[str, int] = {}
            for addr, ins in instrs:
                if start <= addr <= end:
                    op = ins.split()[0]
                    counts[sass_class(op)] += 1
                    opcodes[op.split(".")[0]] = \
                        opcodes.get(op.split(".")[0], 0) + 1
            found.append({"start": start, "end": end, "counts": counts,
                          "opcodes": opcodes})
        out[name] = found
    return out


def screen_row_loops(text: str) -> dict:
    """Per-row class counts of each ``screen_kernel<C>`` row loop (the
    innermost loops holding a warp max, one per DP row), in address
    order: ``{C: [{"rows_per_trip", "per_row": {class: n}, ...}]}``."""
    out: dict[int, list] = {}
    for name, loops in sass_loops(text).items():
        m = re.search(r"screen_kernelILi(\d+)E", name)
        if not m:
            continue
        rows = []
        for lp in loops:
            per_trip = lp["counts"]["redux"]
            if per_trip and lp["counts"]["shfl"]:
                rows.append(dict(lp, rows_per_trip=per_trip, per_row={
                    k: lp["counts"][k] / per_trip for k in CLASSES}))
        out[int(m.group(1))] = rows
    return out


def probe_loops(text: str) -> dict:
    """The rolled step loop of each probe mix: ``{mix: loop}``."""
    out = {}
    for name, loops in sass_loops(text).items():
        m = re.search(r"probe_kernelILi(\d)E", name)
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
