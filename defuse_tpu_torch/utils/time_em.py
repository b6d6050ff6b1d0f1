#!/usr/bin/env python3
"""Time the batched EM's kernel (``em_rows_kernel``) at the bench width.

    python3 defuse_tpu_torch/utils/time_em.py [--tree DIR] [--reps N]

Builds the bench dataset (``utils/synth.build_dataset``, as
``chip_smoke.py`` phase 12 does), takes every bin pair of its ``spanning``
file through ``prepare_batch`` (381 instances, 3,806 (instance, K) rows,
widest N 141) and times, on the card:

* the kernel alone: the whole batch in one launch at its padded width,
  float64 and float32, from a fresh copy of the carry each time (CUDA
  events around the wrapper's call; the median of N);
* the kernel's cost a batch-iteration: every row held running (``tol``
  below 0, so no row converges; a row that fails still leaves) for 10 and
  for 30 iterations, float64: the difference over 20;
* ``run_em`` as ``run_batch`` calls it (bucketed, segments of
  ``SEGMENT_ITERS``), in one segment, and in one launch at the padded width
  (``chunk_rows=0``): wall seconds, the median of N.

Each run's ``a``, ``b``, ``ll`` are digested, so trees whose kernels differ
in arithmetic show it.  ``--tree`` names the checkout whose
``defuse_tpu_torch`` is timed (default: the one this file lies in), so two
trees can be set side by side on one card, in turns.  Prints one JSON line.
"""

from __future__ import annotations

import argparse
import hashlib
import json
import pathlib
import statistics
import sys
import tempfile
import time

HERE = pathlib.Path(__file__).resolve().parents[2]


def bench_batch(work: pathlib.Path):
    from defuse_tpu_torch.cluster import matepair_em_batch as em
    from defuse_tpu_torch.cluster.discordant import collect_bin_pair_tasks
    from defuse_tpu_torch.cluster.matepair_em import EMParams
    from defuse_tpu_torch.io.sam import iter_compact, load_alignments
    from defuse_tpu_torch.utils import synth
    params = EMParams(synth.MEAN, synth.STD, synth.PREC, synth.MINCL)
    _ds, paths, _n = synth.build_dataset(work)
    tasks = collect_bin_pair_tasks(
        load_alignments(iter_compact(str(paths["spanning"]))), params)
    return em.prepare_batch([(t.x, t.y, t.u) for t in tasks], params), params


def digest(*arrays) -> str:
    h = hashlib.sha256()
    for a in arrays:
        h.update(a.tobytes())
    return h.hexdigest()[:16]


def measure(tree: str, reps: int) -> dict:
    import torch

    from defuse_tpu_torch.cluster import matepair_em_batch as em
    from defuse_tpu_torch.core.devices import gpu_identity, require_cuda
    from defuse_tpu_torch.ops import em_cuda

    dev = require_cuda("cuda")
    (HERE / "build").mkdir(exist_ok=True)
    with tempfile.TemporaryDirectory(dir=HERE / "build") as work:
        batch, params = bench_batch(pathlib.Path(work))
    sigma = params.fragment_stddev
    B, KM, N = batch.r0.shape
    out = {"card": gpu_identity().splitlines()[0], "tree": tree, "rows": B,
           "K": KM, "N": N}

    def launch(dtype, max_iters, tol):
        """Milliseconds of one launch on the whole batch, and its
        outputs."""
        x, y, u = (torch.as_tensor(v, dtype=dtype, device=dev)
                   for v in (batch.x, batch.y, batch.u))
        n, k = (torch.as_tensor(v, dtype=torch.int32, device=dev)
                for v in (batch.n, batch.k))
        r = torch.as_tensor(batch.r0, dtype=dtype, device=dev)
        r = torch.where(torch.arange(KM, device=dev)[None, :, None]
                        < k[:, None, None], r, 0.0).contiguous()
        a = torch.zeros((B, KM), dtype=dtype, device=dev)
        b = torch.zeros_like(a)
        ll = torch.full((B,), -float(em.BIG), dtype=dtype, device=dev)
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        torch.cuda.synchronize()
        start.record()
        em_cuda.em_rows(
            x, y, u, n, k, r, a, b, ll, max_iters=max_iters,
            never=em.MAX_ITERS + 1, sigma=sigma, lam=em.LAMBDA, tol=tol)
        end.record()
        torch.cuda.synchronize()
        return start.elapsed_time(end), (a.cpu().numpy(), b.cpu().numpy(),
                                         ll.cpu().numpy())

    for name, dtype in (("float64", torch.float64),
                        ("float32", torch.float32)):
        launch(dtype, em.MAX_ITERS, em.TOLERANCE)  # loads the kernel
        runs = [launch(dtype, em.MAX_ITERS, em.TOLERANCE)
                for _ in range(reps)]
        out[f"kernel_ms_{name}"] = statistics.median(ms for ms, _o in runs)
        out[f"kernel_ms_{name}_all"] = [ms for ms, _o in runs]
        out[f"digest_{name}"] = digest(*runs[0][1])
    held = {}
    for iters in (10, 30):
        held[iters] = statistics.median(
            launch(torch.float64, iters, -1.0)[0] for _ in range(reps))
    out["held_ms"] = held
    out["ms_per_batch_iteration"] = (held[30] - held[10]) / 20

    def wall(**kw):
        times = []
        for _ in range(reps):
            t0 = time.perf_counter()
            em.run_em(batch, params, torch.float64, dev, **kw)
            torch.cuda.synchronize()
            times.append(time.perf_counter() - t0)
        return statistics.median(times)

    wall()
    out["run_em_s"] = wall()
    out["run_em_stats"] = dict(em.EM_RUN_STATS)
    out["one_launch_s"] = wall(chunk_rows=0)
    segment = em.SEGMENT_ITERS
    em.SEGMENT_ITERS = em.MAX_ITERS
    try:
        out["one_segment_s"] = wall()
    finally:
        em.SEGMENT_ITERS = segment
    return out


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--tree", default=str(HERE))
    ap.add_argument("--reps", type=int, default=5)
    args = ap.parse_args()
    tree = str(pathlib.Path(args.tree).resolve())
    sys.path.insert(0, tree)
    import defuse_tpu_torch
    if not pathlib.Path(defuse_tpu_torch.__file__).resolve().is_relative_to(
            pathlib.Path(tree)):
        raise RuntimeError(f"defuse_tpu_torch came from "
                           f"{defuse_tpu_torch.__file__}, not {tree}")
    print(json.dumps(measure(tree, args.reps)), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
