#!/usr/bin/env python3
"""Time the screen kernel at the three shapes ``PERF.md`` uses.

    python3 defuse_tpu_torch/utils/time_screen.py [--tree DIR]

Prints one JSON line: the card (``nvidia-smi`` name and power limit), the
tree, and milliseconds of ``screen_candidates`` at the discover shape
(46,953 candidates, R 256 trimmed to 220, L 64), the roofline shape (R 256,
50 bp, 16,384 and 65,536 candidates, with the marginal ns a candidate) and
the scale shape (1,048,576 candidates, R 512 trimmed to 480, L 128), each
the mean of 10 launches after a warm-up.

``--tree`` names the checkout whose ``defuse_tpu_torch`` is timed (default:
the one this file lies in), so two commits can be set side by side on one
card: unpack the other commit with ``git archive`` and run this file once
per tree, in turns.  The inputs always come from this
checkout's ``chip_smoke.py`` generators and seeds, and only entry points
that every commit of the port has are called.
"""

from __future__ import annotations

import argparse
import importlib.util
import json
import pathlib
import sys

HERE = pathlib.Path(__file__).resolve().parents[2]
REPS = 10


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--tree", default=str(HERE))
    tree = str(pathlib.Path(ap.parse_args().tree).resolve())
    sys.path.insert(0, tree)

    import numpy as np
    import torch
    from defuse_tpu_torch.convert import screen_min_scores, screen_operands
    from defuse_tpu_torch.core.devices import gpu_identity, require_cuda
    from defuse_tpu_torch.ops.split_dp_cuda import screen_candidates
    from defuse_tpu_torch.utils.profiling import cuda_time_ms

    spec = importlib.util.spec_from_file_location("smoke_inputs",
                                                  HERE / "chip_smoke.py")
    smoke = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(smoke)

    dev = require_cuda("cuda")
    out = {"card": gpu_identity().splitlines()[0], "tree": tree}

    rng = np.random.default_rng(2024)
    for name, shape in (
            ("discover", (smoke.MAIN_B, smoke.MAIN_U, smoke.MAIN_R,
                          smoke.MAIN_L, smoke.MAIN_READ, smoke.MAIN_FLANK)),
            ("scale", (smoke.SCALE_B, smoke.SCALE_U, smoke.SCALE_R,
                       smoke.SCALE_L, smoke.SCALE_READ, smoke.SCALE_FLANK))):
        ops_np, _mask = smoke.screen_set(rng, *shape, 120)
        ops = screen_operands(*ops_np, dev)
        out[f"{name}_ms"] = cuda_time_ms(lambda: screen_candidates(*ops),
                                         REPS)

    rng = np.random.default_rng(0)
    batches, flanks, R, L, read = (16_384, 65_536), 4096, 256, 64, 50
    acgt = np.frombuffer(b"ACGT", dtype=np.uint8)
    refs = acgt[rng.integers(0, 4, (2, flanks, R))]
    ref_lens = np.full(flanks, R, np.int32)
    reads = np.zeros((batches[1], L), np.uint8)
    reads[:, :read] = acgt[rng.integers(0, 4, (batches[1], read))]
    read_lens = np.full(batches[1], read, np.int32)
    ops = screen_operands(refs[0], ref_lens, refs[1], ref_lens,
                          rng.integers(0, flanks, batches[1]), reads,
                          read_lens, screen_min_scores(read_lens), dev)
    times = []
    for b in batches:
        sub = ops[:4] + tuple(a[:b] for a in ops[4:])
        times.append(cuda_time_ms(lambda: screen_candidates(*sub), REPS))
    out["roofline_ms"] = times
    out["roofline_marginal_ns"] = (times[1] - times[0]) * 1e6 / \
        (batches[1] - batches[0])
    torch.cuda.synchronize()
    print(json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
