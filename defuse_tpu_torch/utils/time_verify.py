#!/usr/bin/env python3
"""Time the verify kernel at the three shapes ``PERF.md`` uses.

    python3 defuse_tpu_torch/utils/time_verify.py [--tree DIR]

Prints one JSON line: the card (``nvidia-smi`` name and power limit), the
tree, and per shape the kernel's milliseconds at two candidate counts with
the marginal ns a candidate between them, each from a CUDA graph of 20
launches, the least of 3 rounds:

* ``A``: 4,000,000 bases, 20,000 reads of 50 bp, 65,536 and 524,288
  candidates with random ``read_idx``;
* ``B``: the same candidates sorted by (read, position), as
  ``SeedIndex.candidates`` hands them over;
* ``C``: 3.1e9 bases (a 1.24 GB plane), 1,048,576 reads of 100 bp, 8 sorted
  candidates a read: 1,048,576 and 8,388,608 candidates.

``--tree`` names the checkout whose ``defuse_tpu_torch`` is timed (default:
the one this file lies in), so two commits can be set side by side on one
card: unpack the other commit with ``git archive`` and run this file once
per tree, in turns.  The inputs always come from this checkout's generators
and seeds (``chip_smoke.verify_shape``, ``utils/synth.verify_genome_case``)
and reach each tree in its own operand types, as its
``convert.verify_operands`` makes them; only entry points that every commit
of the port has are called.
"""

from __future__ import annotations

import argparse
import importlib.util
import json
import pathlib
import sys

HERE = pathlib.Path(__file__).resolve().parents[2]
REPS, ROUNDS = 20, 3


def load(name, path):
    spec = importlib.util.spec_from_file_location(name, path)
    mod = importlib.util.module_from_spec(spec)
    sys.modules[name] = mod
    spec.loader.exec_module(mod)
    return mod


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--tree", default=str(HERE))
    tree = str(pathlib.Path(ap.parse_args().tree).resolve())
    sys.path.insert(0, tree)

    import numpy as np
    import torch
    from defuse_tpu_torch.convert import verify_operands
    from defuse_tpu_torch.core.devices import gpu_identity, require_cuda
    from defuse_tpu_torch.ops.verify_cuda import verify_packed3
    from defuse_tpu_torch.utils.profiling import cuda_time_ms

    # this checkout's generators, beside the tree's package
    smoke = load("smoke_inputs", HERE / "chip_smoke.py")
    synth = load("defuse_tpu_torch.utils.synth_inputs",
                 HERE / "defuse_tpu_torch" / "utils" / "synth.py")

    dev = require_cuda("cuda")
    out = {"card": gpu_identity().splitlines()[0], "tree": tree}

    def timed(ops, L, counts):
        ref3, w10, l10, reads3, ridx, lens = ops
        ms = [cuda_time_ms(
            lambda c=c: verify_packed3(ref3, w10[:c], l10[:c], reads3,
                                       ridx[:c], lens, L),
            REPS, graph=True, rounds=ROUNDS) for c in counts]
        return {"ms": ms, "marginal_ns": (ms[1] - ms[0]) * 1e6 /
                (counts[1] - counts[0])}

    rng = np.random.default_rng(2024)
    codes, starts, reads, ridx, lens = smoke.verify_shape(rng)
    by = np.lexsort((starts, ridx))
    for name, order in (("A", slice(None)), ("B", by)):
        ops = verify_operands(codes, starts[order], reads, ridx[order], lens,
                              dev)
        out[name] = timed(ops, smoke.VERIFY_READ, smoke.VERIFY_BATCHES)
    del ops

    # the tree's own type for lane10 (int32 before it became uint8)
    lane_dtype = verify_operands(codes[:100], [0], reads[:1], [0], lens[:1],
                                 dev)[2].dtype
    ops, _is_source, _planted = synth.verify_genome_case(dev, seed=2024)
    ops = ops[:2] + (ops[2].to(lane_dtype),) + ops[3:]
    out["C"] = timed(ops, smoke.GENOME_READ, smoke.GENOME_BATCHES)
    torch.cuda.synchronize()
    print(json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
