#!/usr/bin/env python3
"""Time the no-native realign's two DP kernels on the route's own operands.

    python3 defuse_tpu_torch/utils/time_rowmax.py --capture FILE
    python3 defuse_tpu_torch/utils/time_rowmax.py --ops FILE [--tree DIR]
    python3 defuse_tpu_torch/utils/time_rowmax.py --phases FILE

``--capture`` runs discover without the native library on the card
(``DEFUSE_NO_NATIVE=1``, the dataset cut as ``chip_smoke.py`` phase 10 cuts
it, the batched EM) and saves the operands of its row-maxima call and of
its tie-column calls to FILE (``.npz``).

``--ops`` times, on the operands in FILE, the row maxima as the caller
hands them and sorted on the host by read and flank length (so that like
lengths share each lane group and warp), each as the kernel alone (the
mean of REPS launches replayed from one CUDA graph, so no host time lies
between them) and as the whole wrapper call (REPS calls back to back); the
plain version; what the sort costs the host; the tie columns on the
route's two sides (flank 1, and the reversed flank 2; a capture that holds
one call of both is cut back into its halves) and on operands made from
them (``tie_variants``): each side as captured, each cut to one captured
row an instance (its last), side 1 tiled eight times, both sides in one
call, the lone pair with the most rows, and two instances that capture no
row (the launch floor); each as kernel, call and plain; and a digest of
each ``screen_kernel``'s and ``rowmax_kernel``'s machine code.  Every
result is checked against the plain version.  Prints one JSON line.

``--phases`` builds ``csrc/split_dp.cu`` once more with its phase clock
(``-DTIE_PHASE_CLOCK``, into ``build/tie_phases/``): each warp of the tie
kernel stamps the SM clock where each phase ends (prologue: the lengths,
the read's rows and the row set from row_sel; the warp's plan; the
registers' first row; the row loop; the slots' group mins; the writes),
and prints, for
the floor, the lone pair, side 1 and both sides, each phase's cycles (mean
and most over the warps) and the row loop's cycles a row.

``--tree`` names the checkout whose ``defuse_tpu_torch`` is timed
(default: the one this file lies in), so two commits can be set side by
side on one card, in turns, as with ``utils/time_screen.py``.
"""

from __future__ import annotations

import argparse
import hashlib
import json
import os
import pathlib
import sys
import tempfile
import time

HERE = pathlib.Path(__file__).resolve().parents[2]
REPS = 20


def capture(path: pathlib.Path) -> None:
    import importlib.util
    import numpy as np
    from defuse_tpu_torch.ops import split_dp_cuda
    from defuse_tpu_torch.pipeline import discover
    from defuse_tpu_torch.utils import synth

    spec = importlib.util.spec_from_file_location("smoke_inputs",
                                                  HERE / "chip_smoke.py")
    smoke = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(smoke)
    seen = {"rowmax": [], "tie": []}
    rowmax, tie = discover.dp_row_maxima_cuda, split_dp_cuda.dp_tie_columns_cuda
    discover.dp_row_maxima_cuda = \
        lambda *ops: seen["rowmax"].append(ops) or rowmax(*ops)
    split_dp_cuda.dp_tie_columns_cuda = \
        lambda *ops: seen["tie"].append(ops) or tie(*ops)
    with tempfile.TemporaryDirectory() as work:
        work = pathlib.Path(work)
        _ds, paths, _n = synth.build_dataset(
            work, smoke.NO_NATIVE_FUSIONS, smoke.NO_NATIVE_BACKGROUND)
        paths["fastq1"], paths["fastq2"] = smoke.raw_fastqs(work)
        discover.discover_fusions(outdir=str(work / "out"), device="cuda",
                                  em_mode="device",
                                  **smoke.discover_kwargs(paths))
    arrays = {f"rowmax{i}": t.cpu().numpy()
              for i, t in enumerate(seen["rowmax"][0])}
    for k, ops in enumerate(seen["tie"]):
        arrays |= {f"tie{k}_{i}": t.cpu().numpy() for i, t in enumerate(ops)}
    np.savez(path, **arrays)


def sass_digests(kernels=("screen_kernel", "rowmax_kernel")) -> dict:
    """sha256 of the instructions of each instantiation of ``kernels`` in
    the built ``split_dp`` library (addresses are relative to the
    function), by kernel and template arguments: the mangled names carry a
    hash of the source file, which any edit moves."""
    import re
    from defuse_tpu_torch.ops import _build
    out, name, lines = {}, None, []
    for line in _build.sass("split_dp").splitlines() + ["Function : end"]:
        m = re.search(r"Function\s*:\s*(\S+)", line)
        if m:
            k = name and re.search(
                rf"({'|'.join(kernels)})ILi(\d+)ELi(\d+)E", name)
            if k:
                out[f"{k[1]}<{k[2]}, {k[3]}>"] = hashlib.sha256(
                    "\n".join(lines).encode()).hexdigest()[:16]
            name, lines = m.group(1), []
        elif name:
            lines.append(line.strip())
    return out


def tie_sides(data) -> list:
    """The route's two tie-column operand sets (refs, ref_lens, reads,
    read_lens, row_sel as numpy): its two calls, or the halves of its one
    call of both sides."""
    calls = sorted({k.split("_")[0] for k in data.files if k.startswith("tie")})
    ops = [[data[f"{c}_{i}"] for i in range(5)] for c in calls]
    if len(ops) == 1:
        half = ops[0][0].shape[0] // 2
        ops = [[a[:half] for a in ops[0]], [a[half:] for a in ops[0]]]
    return ops


def last_row_only(ops):
    """``ops`` with each instance's row selection cut to its largest row in
    [1, L] (in its own slot; every other slot -1): the same DP rows, one
    capture an instance."""
    import numpy as np
    sel = ops[4]
    L = ops[2].shape[1]
    valid = (sel >= 1) & (sel <= L)
    last = np.where(valid, sel, -1).max(axis=1, keepdims=True)
    keep = (sel == last) & valid
    keep &= np.cumsum(keep, axis=1) == 1
    return [*ops[:4], np.where(keep, sel, -1).astype(np.int32)]


def tie_variants(sides) -> dict:
    """The operand sets ``--ops`` times the tie columns on: (a) each side,
    (b) each side with one capture an instance, (c) side 1 tiled 8 times,
    (d) both sides in one call, the lone pair of side 1 with the largest
    selected rows (one group: a warp's row chain), and (e) two instances
    that capture nothing (the launch floor of a replay)."""
    import numpy as np
    one, two = sides
    L = one[2].shape[1]
    rows = np.where((one[4] >= 1) & (one[4] <= L), one[4], 0).max(axis=1)
    b = int(np.argmax(rows)) // 2 * 2
    return {"side1": one, "side2": two,
            "side1_last_row": last_row_only(one),
            "side2_last_row": last_row_only(two),
            "side1_x8": [np.concatenate([a] * 8) for a in one],
            "both_sides": [np.concatenate(ab) for ab in zip(one, two)],
            "lone_pair": [a[b:b + 2] for a in one],
            "floor": [*(a[:2] for a in one[:4]),
                      np.full_like(one[4][:2], -1)]}


def measure(path: pathlib.Path, tree: str) -> dict:
    import numpy as np
    import torch
    from defuse_tpu_torch.core.devices import gpu_identity, require_cuda
    from defuse_tpu_torch.ops import split_dp_batch, split_dp_cuda
    from defuse_tpu_torch.utils.profiling import cuda_time_ms

    dev = require_cuda("cuda")
    data = np.load(path)
    host = [data[f"rowmax{i}"] for i in range(4)]
    ops = [torch.from_numpy(a).to(dev) for a in host]
    rowmax = split_dp_cuda.dp_row_maxima_cuda
    want = split_dp_batch.dp_row_maxima(*ops)

    def timed(fn, check):
        got = fn()
        torch.cuda.synchronize()
        if not check(got):
            raise RuntimeError("kernel differs from the plain version")
        return {"kernel_ms": cuda_time_ms(fn, REPS, graph=True),
                "call_ms": cuda_time_ms(fn, REPS)}

    out = {"card": gpu_identity().splitlines()[0], "tree": tree,
           "instances": int(host[0].shape[0]), "R": int(host[0].shape[1]),
           "L": int(host[2].shape[1])}
    out["rowmax"] = timed(lambda: rowmax(*ops),
                          lambda got: torch.equal(got, want))
    t0 = time.perf_counter()
    order = np.lexsort((host[1], host[3]))
    out["sort_host_ms"] = (time.perf_counter() - t0) * 1e3
    perm = torch.from_numpy(order).to(dev)
    sorted_ops = [t[perm].contiguous() for t in ops]
    out["rowmax_sorted"] = timed(lambda: rowmax(*sorted_ops),
                                 lambda got: torch.equal(got, want[perm]))
    out["rowmax_plain_ms"] = cuda_time_ms(
        lambda: split_dp_batch.dp_row_maxima(*ops), 2)

    kernel = getattr(split_dp_cuda, "dp_tie_columns_cuda", None)
    out["tie"] = {}
    for name, arrays in tie_variants(tie_sides(data)).items():
        tops = [torch.from_numpy(np.ascontiguousarray(a)).to(dev)
                for a in arrays]
        plain = split_dp_batch.dp_tie_columns(*tops)
        rec = {"instances": int(tops[0].shape[0]),
               "rows": int(tops[4].shape[1]),
               "plain_ms": cuda_time_ms(
                   lambda: split_dp_batch.dp_tie_columns(*tops), 2)}
        if kernel is not None:
            rec |= timed(lambda: kernel(*tops), lambda got: all(
                torch.equal(g, w) for g, w in zip(got, plain)))
        out["tie"][name] = rec
    out["sass"] = sass_digests()
    return out


PHASES = ("prologue", "plan", "first_row", "row_loop", "slot_mins",
          "writes")


def phase_clock(path: pathlib.Path, tree: str) -> dict:
    """The tie kernel's phases in SM cycles on the route's operands, from a
    build of ``tree``'s ``split_dp.cu`` with its phase clock."""
    import ctypes
    import subprocess
    import numpy as np
    import torch
    from defuse_tpu_torch.align.split_dp import (GAP, MATCH,
                                                 MIN_SPLIT_SCORE, MISMATCH)
    from defuse_tpu_torch.core.devices import gpu_identity, require_cuda
    from defuse_tpu_torch.ops import _build, split_dp_batch, split_dp_cuda

    dev = require_cuda("cuda")
    out = HERE / "build" / "tie_phases" / "libsplit_dp_phases.so"
    out.parent.mkdir(parents=True, exist_ok=True)
    proc = subprocess.run(
        [_build.find_nvcc(), *_build.NVCC_FLAGS, "-DTIE_PHASE_CLOCK", "-o",
         str(out), str(pathlib.Path(tree) / "defuse_tpu_torch" / "csrc" /
                       "split_dp.cu")], capture_output=True, text=True)
    if proc.returncode:
        raise RuntimeError(f"nvcc failed:\n{proc.stderr}")
    lib = ctypes.CDLL(str(out))
    launch = lib.split_dp_tie_columns
    launch.argtypes = split_dp_cuda._SIGS["split_dp_tie_columns"]
    lib.tie_phase_clock.argtypes = [ctypes.c_void_p]
    variants = tie_variants(tie_sides(np.load(path)))
    rec = {"card": gpu_identity().splitlines()[0], "tree": tree,
           "phases": PHASES}
    for name in ("floor", "lone_pair", "side1", "both_sides"):
        arrays = variants[name]
        ts = [torch.from_numpy(np.ascontiguousarray(a)).to(dev)
              for a in arrays]
        (B, R), L, M = ts[0].shape, ts[2].shape[1], ts[4].shape[1]
        rowmax = torch.empty((B, M), dtype=torch.int32, device=dev)
        packed = torch.empty((B, M, (R + 32) // 32), dtype=torch.int32,
                             device=dev)
        for _ in range(2):  # the second launch is the one read
            err = launch(ts[0].data_ptr(), ts[1].data_ptr(), R,
                         ts[2].data_ptr(), L, ts[4].data_ptr(), M,
                         rowmax.data_ptr(), packed.data_ptr(), B, MATCH,
                         MISMATCH, GAP, MIN_SPLIT_SCORE,
                         torch.cuda.current_stream().cuda_stream)
            torch.cuda.synchronize()
            if err:
                raise RuntimeError(f"tie kernel launch failed: {err}")
        want = split_dp_batch.dp_tie_columns(*ts)
        if not (torch.equal(rowmax, want[0]) and torch.equal(packed,
                                                             want[1])):
            raise RuntimeError("clocked tie kernel differs from plain")
        clock = np.zeros((8192, len(PHASES) + 1), np.int64)
        if lib.tie_phase_clock(clock.ctypes.data):
            raise RuntimeError("could not read the phase clock")
        per_warp = 32 // lib.split_dp_lanes(R) * 2
        warps = (B + per_warp - 1) // per_warp
        cycles = np.diff(clock[:warps], axis=1)
        sel = arrays[4]
        last = np.where((sel >= 1) & (sel <= L), sel, 0).max(axis=1)
        rows = np.array([last[w * per_warp:(w + 1) * per_warp].max()
                         for w in range(warps)])
        busy = rows > 0
        rec[name] = {
            "instances": int(B), "warps": int(warps),
            "mean": dict(zip(PHASES, cycles.mean(axis=0).round(1).tolist())),
            "most": dict(zip(PHASES, cycles.max(axis=0).tolist())),
            "total_mean": float(cycles.sum(axis=1).mean()),
            "total_most": int(cycles.sum(axis=1).max()),
            "loop_cycles_a_row": float((cycles[busy, 3] / rows[busy]).mean())
            if busy.any() else None}
    return rec


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--capture", type=pathlib.Path)
    ap.add_argument("--ops", type=pathlib.Path)
    ap.add_argument("--phases", type=pathlib.Path)
    ap.add_argument("--tree", default=str(HERE))
    args = ap.parse_args()
    tree = str(pathlib.Path(args.tree).resolve())
    sys.path.insert(0, tree)
    if args.capture:
        os.environ["DEFUSE_NO_NATIVE"] = "1"
        capture(args.capture)
        return 0
    if args.phases:
        print(json.dumps(phase_clock(args.phases, tree)), flush=True)
        return 0
    if not args.ops:
        ap.error("one of --capture, --ops or --phases")
    print(json.dumps(measure(args.ops, tree)), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
