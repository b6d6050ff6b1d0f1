#!/usr/bin/env python3
"""Time the no-native realign's two DP kernels on the route's own operands.

    python3 defuse_tpu_torch/utils/time_rowmax.py --capture FILE
    python3 defuse_tpu_torch/utils/time_rowmax.py --ops FILE [--tree DIR]

``--capture`` runs discover without the native library on the card
(``DEFUSE_NO_NATIVE=1``, the dataset cut as ``chip_smoke.py`` phase 10 cuts
it, the batched EM) and saves the operands of its row-maxima call and of
its two tie-column calls to FILE (``.npz``).

``--ops`` times, on the operands in FILE, the row maxima as the caller
hands them and sorted on the host by read and flank length (so that like
lengths share each lane group and warp), each as the kernel alone (the
mean of REPS launches replayed from one CUDA graph, so no host time lies
between them) and as the whole wrapper call (REPS calls back to back); the
plain version; what the sort costs the host; the tie columns (kernel, call
and plain, where the tree has the kernel); and a digest of each
``screen_kernel``'s machine code.  Every result is checked against the
plain version.  Prints one JSON line.

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


def screen_sass_digests() -> dict:
    """sha256 of each ``screen_kernel``'s instructions in the built
    library (addresses are relative to the function)."""
    import re
    from defuse_tpu_torch.ops import _build
    out, name, lines = {}, None, []
    for line in _build.sass("split_dp").splitlines() + ["Function : end"]:
        m = re.search(r"Function\s*:\s*(\S+)", line)
        if m:
            if name and "screen_kernel" in name:
                out[name] = hashlib.sha256("\n".join(lines).encode()) \
                    .hexdigest()[:16]
            name, lines = m.group(1), []
        elif name:
            lines.append(line.strip())
    return out


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

    out["tie"] = []
    for k in range(2):
        tops = [torch.from_numpy(data[f"tie{k}_{i}"]).to(dev)
                for i in range(5)]
        plain = split_dp_batch.dp_tie_columns(*tops)
        rec = {"winners": int(tops[0].shape[0]), "rows": int(tops[4].shape[1]),
               "plain_ms": cuda_time_ms(
                   lambda: split_dp_batch.dp_tie_columns(*tops), 3)}
        kernel = getattr(split_dp_cuda, "dp_tie_columns_cuda", None)
        if kernel is not None:
            rec |= timed(lambda: kernel(*tops), lambda got: all(
                torch.equal(g, w) for g, w in zip(got, plain)))
        out["tie"].append(rec)
    out["screen_sass"] = screen_sass_digests()
    return out


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--capture", type=pathlib.Path)
    ap.add_argument("--ops", type=pathlib.Path)
    ap.add_argument("--tree", default=str(HERE))
    args = ap.parse_args()
    tree = str(pathlib.Path(args.tree).resolve())
    sys.path.insert(0, tree)
    if args.capture:
        os.environ["DEFUSE_NO_NATIVE"] = "1"
        capture(args.capture)
        return 0
    if not args.ops:
        ap.error("one of --capture or --ops")
    print(json.dumps(measure(args.ops, tree)), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
