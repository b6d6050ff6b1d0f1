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
* the longest row: of the rows with the most iterations and the most
  work (``it_done`` x n x k) in the float64 run, the one whose run alone in
  a launch takes longest; its time alone, and the time of one of its
  iterations (held running for 10 and for 60 iterations: the difference
  over 50), what the kernel's tail waits on;
* ``run_em`` as ``run_batch`` calls it (bucketed, segments of
  ``SEGMENT_ITERS``), in one segment, and in one launch at the padded width
  (``chunk_rows=0``): wall seconds, the median of N;
* where the kernel's time goes (``phase_cycles``): a copy of the tree's
  ``csrc/em_row.cuh`` and ``csrc/em.cu`` under ``build/em_phases/`` with
  a clock (``clock64()``, SM cycles) read by each block's thread 0 at
  every barrier of the loop, built as the kernel is: the cycles a
  row-iteration spends in the M-step (and in its sums where the tree has
  them), the E-step, the log-likelihood and the responsibilities, over
  the whole batch run to its end and over the longest row alone, and the
  M-step's share of them.  The copy waits at two barriers more a
  row-iteration than the kernel does; the shares, not its times, are
  read.

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

import numpy as np

HERE = pathlib.Path(__file__).resolve().parents[2]
PHASES = ("m_sums", "m_step", "e_step", "ll", "resp")

# the copy's clock: PROF_T starts a phase, PROF(i) ends phase i at a barrier
_CLOCK = """
#ifdef __CUDACC__
__device__ unsigned long long g_phase[8];
#endif
#ifdef __CUDA_ARCH__
#define PROF_T long long _t = clock64();
#define PROF(i) __syncthreads(); if (threadIdx.x == 0) { \\
    long long _u = clock64(); \\
    atomicAdd(&g_phase[i], (unsigned long long)(_u - _t)); _t = _u; }
#define PROF_ITER if (threadIdx.x == 0) atomicAdd(&g_phase[7], 1ull);
#else
#define PROF_T
#define PROF(i)
#define PROF_ITER
#endif
"""
_READ = """
extern "C" int em_phase_cycles(unsigned long long* out) {
  cudaError_t e = cudaDeviceSynchronize();
  if (e == cudaSuccess) e = cudaMemcpyFromSymbol(out, em::g_phase, 64);
  unsigned long long z[8] = {0};
  if (e == cudaSuccess) e = cudaMemcpyToSymbol(em::g_phase, z, 64);
  return (int)e;
}
"""
# the loop's M-step, as the tree writes it: the warp form (its sums first),
# or the walk of the trees before it
_M_STEP = ("    m_step_row<kWalk>(team, w, n, k, KM, c);\n",
           """    for (int j = team.rank(); j < KM; j += team.size()) {
      const T nk = j < k ? m_step(w.r + j * w.ld, w, n, c, w.a[j], w.b[j])
                         : T(0);
      w.w[j] = nk / n_points;
    }
""")
_SUMS = "  m_sums(team, w, n, k);\n  team.sync();\n"
_SUMS_THEN = "  const Chunk<T> chunk = chunk_of(w, team.warp());\n  for (int j = " \
    "team.warp(); j < KM;"
_E_STEP = """    team.sync();
    bool empty = false;
    for (int i = team.rank(); i < n; i += team.size())
      empty = e_point(w, i, k, c) || empty;
    failed = team.any(empty);
    const T ll = team.ll_sum(w.logp, n, w.slot);
"""
_RESP = """        resp_point(w, i, k, KM, c);
      team.sync();
    }
"""


def phase_library(tree: pathlib.Path):
    """The tree's EM kernel with the phase clock, built into
    ``build/em_phases/`` (nvcc, the kernel's flags) and loaded."""
    import ctypes
    import subprocess

    from defuse_tpu_torch.ops import _build
    csrc = tree / "defuse_tpu_torch" / "csrc"
    row = (csrc / "em_row.cuh").read_text()
    m_step = next(m for m in _M_STEP if m in row)
    edits = [("namespace em {\n", "namespace em {\n" + _CLOCK),
             (m_step + _E_STEP, "    PROF_T\n" + m_step +
              _E_STEP.replace("    bool empty", "    PROF(1)\n    bool empty")
              .replace("    const T ll", "    PROF(2)\n    const T ll") +
              "    PROF(3)\n"),
             (_RESP, _RESP + "    PROF(4)\n    PROF_ITER\n")]
    if _SUMS + _SUMS_THEN in row:
        edits.append((_SUMS + _SUMS_THEN,
                      "  PROF_T\n" + _SUMS + "  PROF(0)\n" + _SUMS_THEN))
    for old, new in edits:
        if row.count(old) != 1:
            raise RuntimeError(f"em_row.cuh of {tree} has no single {old!r}")
        row = row.replace(old, new)
    source = (csrc / "em.cu").read_text() + _READ
    digest = hashlib.sha256((row + source).encode()).hexdigest()[:16]
    out = HERE / "build" / "em_phases" / digest
    lib = out / "libem_phases.so"
    if not lib.exists():
        out.mkdir(parents=True, exist_ok=True)
        (out / "em_row.cuh").write_text(row)
        (out / "em.cu").write_text(source)
        proc = subprocess.run([_build.find_nvcc(), *_build.flags("em"), "-o",
                               str(lib), str(out / "em.cu")],
                              capture_output=True, text=True)
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc failed building the phase clock:\n"
                               f"{proc.stderr}")
    return ctypes.CDLL(str(lib))


def phase_cycles(tree: pathlib.Path, batch, params, rows=None) -> dict:
    """SM cycles a row-iteration in each phase of the tree's kernel, on the
    batch's ``rows`` (all by default) run to their end in float64, and the
    M-step's share (``m_step`` includes ``m_sums``)."""
    import ctypes

    import torch

    from defuse_tpu_torch.cluster import matepair_em_batch as em
    lib = phase_library(tree)
    rows = slice(None) if rows is None else rows
    dev = torch.device("cuda")
    x, y, u = (torch.as_tensor(v[rows], dtype=torch.float64, device=dev)
               for v in (batch.x, batch.y, batch.u))
    n, k = (torch.as_tensor(v[rows], dtype=torch.int32, device=dev)
            for v in (batch.n, batch.k))
    B, KM, N = len(n), batch.r0.shape[1], batch.r0.shape[2]
    r = torch.as_tensor(batch.r0[rows], dtype=torch.float64, device=dev)
    r = torch.where(torch.arange(KM, device=dev)[None, :, None]
                    < k[:, None, None], r, 0.0).contiguous()
    a = torch.zeros((B, KM), dtype=torch.float64, device=dev)
    b, w = torch.zeros_like(a), torch.zeros_like(a)
    ll = torch.full((B,), -float(em.BIG), dtype=torch.float64, device=dev)
    flags = [torch.zeros(B, dtype=torch.uint8, device=dev) for _ in range(2)]
    it_done = torch.zeros(B, dtype=torch.int32, device=dev)
    size = ctypes.c_longlong()
    lib.em_scratch_row_bytes(KM, N, 1, ctypes.byref(size))
    scratch = torch.empty(max(B * size.value, 1), dtype=torch.uint8,
                          device=dev)
    counts = (ctypes.c_ulonglong * 8)()
    lib.em_phase_cycles(counts)  # zero the counters
    P, I, D = ctypes.c_void_p, ctypes.c_int, ctypes.c_double
    lib.em_rows_f64.argtypes = [P] * 14 + [I] * 5 + [D] * 3 + [P]
    err = lib.em_rows_f64(
        *(t.data_ptr() for t in (x, y, u, n, k, r, a, b, w, ll, *flags,
                                 it_done)),
        scratch.data_ptr() if size.value else None, B, KM, N, em.MAX_ITERS,
        em.MAX_ITERS + 1, params.fragment_stddev, em.LAMBDA, em.TOLERANCE,
        torch.cuda.current_stream().cuda_stream)
    if err or lib.em_phase_cycles(counts):
        raise RuntimeError(f"phase clock: CUDA error {err}")
    iters = max(counts[7], 1)
    out = {name: counts[i] / iters for i, name in enumerate(PHASES)}
    whole = sum(out[name] for name in PHASES[1:])
    return {"row_iterations": counts[7], "cycles": out,
            "m_step_share": out["m_step"] / whole if whole else None}


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

    def launch(dtype, max_iters, tol, rows=slice(None)):
        """Milliseconds of one launch on the batch's ``rows``, its
        outputs and each row's ``it_done``."""
        x, y, u = (torch.as_tensor(v[rows], dtype=dtype, device=dev)
                   for v in (batch.x, batch.y, batch.u))
        n, k = (torch.as_tensor(v[rows], dtype=torch.int32, device=dev)
                for v in (batch.n, batch.k))
        r = torch.as_tensor(batch.r0[rows], dtype=dtype, device=dev)
        r = torch.where(torch.arange(KM, device=dev)[None, :, None]
                        < k[:, None, None], r, 0.0).contiguous()
        a = torch.zeros((len(n), KM), dtype=dtype, device=dev)
        b = torch.zeros_like(a)
        ll = torch.full((len(n),), -float(em.BIG), dtype=dtype, device=dev)
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        torch.cuda.synchronize()
        start.record()
        it_done = em_cuda.em_rows(
            x, y, u, n, k, r, a, b, ll, max_iters=max_iters,
            never=em.MAX_ITERS + 1, sigma=sigma, lam=em.LAMBDA, tol=tol)[3]
        end.record()
        torch.cuda.synchronize()
        return start.elapsed_time(end), (a.cpu().numpy(), b.cpu().numpy(),
                                         ll.cpu().numpy()), \
            it_done.cpu().numpy()

    for name, dtype in (("float64", torch.float64),
                        ("float32", torch.float32)):
        launch(dtype, em.MAX_ITERS, em.TOLERANCE)  # loads the kernel
        runs = [launch(dtype, em.MAX_ITERS, em.TOLERANCE)
                for _ in range(reps)]
        out[f"kernel_ms_{name}"] = statistics.median(ms for ms, *_o in runs)
        out[f"kernel_ms_{name}_all"] = [ms for ms, *_o in runs]
        out[f"digest_{name}"] = digest(*runs[0][1])
        if name == "float64":
            it_done = runs[0][2]
    held = {}
    for iters in (10, 30):
        held[iters] = statistics.median(
            launch(torch.float64, iters, -1.0)[0] for _ in range(reps))
    out["held_ms"] = held
    out["ms_per_batch_iteration"] = (held[30] - held[10]) / 20
    work = it_done.astype(np.int64) * batch.n * batch.k
    rows = set(np.argsort(-work, kind="stable")[:8].tolist()) | \
        set(np.argsort(-it_done, kind="stable")[:4].tolist())
    alone = {row: statistics.median(
        launch(torch.float64, em.MAX_ITERS, em.TOLERANCE, [row])[0]
        for _ in range(reps)) for row in sorted(rows)}
    longest = max(alone, key=alone.get)
    iters = {m: statistics.median(
        launch(torch.float64, m, -1.0, [longest])[0] for _ in range(reps))
        for m in (10, 60)}
    out["longest_row"] = {
        "row": longest, "it_done": int(it_done[longest]),
        "n": int(batch.n[longest]), "k": int(batch.k[longest]),
        "alone_ms": alone[longest], "held_ms": iters,
        "ms_per_iteration": (iters[60] - iters[10]) / 50,
        "candidates_ms": {int(r): t for r, t in alone.items()}}

    def wall(**kw):
        times = []
        for _ in range(reps):
            t0 = time.perf_counter()
            em.run_em(batch, params, torch.float64, dev, **kw)
            torch.cuda.synchronize()
            times.append(time.perf_counter() - t0)
        return statistics.median(times)

    wall()
    out["phases"] = {"batch": phase_cycles(pathlib.Path(tree), batch, params),
                     "longest_row": phase_cycles(pathlib.Path(tree), batch,
                                                 params, [longest])}
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
