#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port on one NVIDIA GPU.

    python3 chip_smoke.py

Phases (any failure raises and exits non-zero; nothing is caught):

1. card: nvidia-smi name and power limit, CUDA version; CUDA is required;
2. build: the native host library and the four CUDA sources, from
   source (one ``nvcc`` each, all started together);
3. kernel = plain version, exactly, for the screen, the row maxima (the
   batch as made and sorted by length, so that other instances share each
   lane group) and the tie columns, over a sweep of flank/read widths and
   edge rows and over the edge cases of
   ``defuse_tpu_torch.utils.synth.EDGE_CASES`` (flank widths off the lane
   grid, flanks far shorter than the table, lengths 0, 1,024-base reads
   that match or mismatch everywhere: the int16 range); the tie columns at
   the rows of ``utils.synth.tie_rows`` (-1, 0, the read's last row, the
   one past it, L, duplicates), across the 32-column words
   (``tie_boundary_case``) and with 40 rows an instance (more captured
   rows than a lane group keeps, so the kernel runs its DP twice); the
   screen timed at the discover path's shape;
4. scale: the screen over a tumour-library candidate set (1,048,576
   reads of 100 bp against 4,096 flank pairs up to 480 bp): kernel time,
   an exact check against the plain version on a 65,536-read subsample,
   and survivors == the planted junction reads;
5. end to end: ``defuse_tpu_torch`` discover on the 92,800-pair bench
   dataset with ``DEFUSE_DEVICE_SCREEN=force``, its artifacts byte-identical
   to its own host-only run (``use_device=False``: every candidate
   realigned, no screen), with the screen kernel's launches counted.
   Identity with ``defuse_tpu`` itself is held by
   ``tests/test_torch_discover.py``;
6. verify kernel = plain version, exactly, on edge cases (every lane,
   candidates in the plane's last word, read lengths 0, 1, 9, 10, 11 and
   L, N on either side, repeated reads) at a read length for each of its
   group widths, its two roofline legs (``gather``, ``compute``) likewise;
   then checked and timed, with the legs, at three shapes: A, the verify
   microbench (4,000,000 bases, 20,000 reads of 50 bp, 65,536 and 524,288
   candidates with random ``read_idx``); B, the same candidates sorted by
   (read, position) as the frontend sends them; C, a genome's plane made on
   the card (3.1e9 bases, 1.24 GB; 1,048,576 reads of 100 bp cut out of it
   with 0-3 planted mismatches; 8 sorted candidates a read), where every
   source window must get its planted count and the plain version holds
   the first 1,048,576 candidates;
7. frontend: the port's ``align_reads`` on the bench dataset's reads with
   ``DEFUSE_DEVICE_VERIFY=force`` (the Python seed path, every candidate
   verified by the kernel, one launch for each call of the verifier) and
   on the native route, artifacts byte-identical, the kernel's launches
   counted (``align.frontend.VERIFY_CALLS`` agrees), both wall times, and
   the verifier's calls kept for phase 14;
8. probe and roofline: each issue-probe mix = its plain version exactly;
   the census of the probe's loops and of every row loop of the screen
   and row-maxima kernels against the machine code (``cuobjdump -sass``),
   within 20% per class; the screen's roofline (its time against the work-based bound
   and against its own census), with the probe's launches counted;
9. the whole ``run``: ``create-ref`` and then ``run`` through
   ``defuse_tpu_torch.cli.main.main`` on the bench dataset's raw fastqs
   (92,800 pairs, 96 planted fusions; genome, gene models and repeats
   written by ``utils.synth.write_run_config``), once on the card and once
   with ``--no-device``: results, annotations and discover artifacts
   byte-identical between the two, every planted gene pair in
   ``results.classify.tsv``, the screen's launches those that the recorded
   ``screen_route`` implies (``auto``), and the stage seconds of both runs;
10. discover without the native library, in a child process with
   ``DEFUSE_NO_NATIVE=1``, on the dataset cut to NO_NATIVE_FUSIONS fusions
   and NO_NATIVE_BACKGROUND background pairs (the Python EM and the Python
   realign take seconds there): artifacts byte-identical to the native
   route's on the same input, one ``rowmax_kernel`` and one ``tie_kernel``
   launch for one row-maxima call and one tie-column call of both sides,
   and no plain version on a CUDA tensor; both kernels against their plain
   versions (the tie columns also against the same call on CPU tensors,
   bit for bit) and timed on the route's own operands, alone (from a CUDA
   graph), as a wrapper call and beside their plain versions, with the row
   maxima's own instructions (``split_dp_census.census_rowmax``) priced at
   the probe's rates; the tie kernel also on operands made from the
   route's (``utils.time_rowmax.tie_variants``: each side alone, one
   captured row an instance, side 1 tiled eight times, the lone pair with
   the most rows, two instances that capture nothing: the launch floor),
   each == plain; then a second child on the same input with
   ``em_mode="device"``, the batched EM on the card in place of the Python
   oracle: the same bytes again, ``em_impl == "cuda"``, ``em_rows_kernel``
   launched and the plain EM loop run on no CUDA tensor, and its
   ``cluster`` stage's seconds beside the oracle child's;
11. ``cohort``: the bench reads dealt out into two libraries, through
   ``cli.main.main(["cohort", ...])`` with two workers sharing the card;
   both libraries ``ok``, ``cohort_fusions.tsv`` not empty;
12. the batched EM at the bench dataset's width: every bin pair of its
   ``spanning`` file through ``prepare_batch`` and ``run_batch`` on the
   card (``em_rows_kernel``, one launch a slab segment, counted against
   the slabs x segments), in float64 and in float32 with the exact
   re-solve, each held membership for membership to
   ``native.em_cluster_batch`` (the exact answer) on the same instances,
   and in float64 to the plain loop's run on the card and to the run on
   CPU tensors; two runs of each type, one launch at the padded width and
   the run in one segment must give the bucketed run's bits of ``a``,
   ``b``, ``ll``, ``ok``; the kernel against the plain loop on the whole
   batch in float64: ``a`` and ``b`` within 1e-4 bases and ``ll`` within
   1e-9 relative on rows with the same ``ok`` and ``it_done``; the
   kernel's two M-steps (``em_cuda.m_step_check``: the sequential walk and
   the warp form the kernel runs) on the same responsibilities, the bench
   batch's after 1, 5 and 20 iterations and edge cases (runs of equal x, y
   or both, equal running sums on both sides, points and components
   without mass, rows of one and two points, paths with no rising entry
   or a rising first entry, paths of several chunks), float64 and
   float32: the same bits of ``a``, ``b`` and ``nk``, a differing row
   printed.  Prints rows, widest N, slabs, segments, iterations,
   row-iterations run and live, the seconds of prepare, the runs and
   select, the native EM's and the plain loop's seconds, the instances
   re-solved on the host, peak device memory, from ``torch.profiler`` the
   kernel's device time (the whole batch in one launch, and inside
   ``run_em``), the launches a call and the device's busy share, a
   batch-iteration's time with every row held running, and the SM cycles
   a row-iteration spends in each phase with the M-step's share
   (``utils/time_em.phase_cycles``);
13. the multi-process path: ``defuse_tpu_torch.entry.entry()`` on the card
   (``rowmax_kernel``) equal to ``entry(device="cpu")`` bit for bit, and
   timed; the phase-9 dataset dealt into two fastq shards and run on two
   processes in one gloo group, both on the card
   (``parallel.launch.rank_device``): each rank's frontend with its global
   fragment-id base, the read-stats sums gathered, rank 0
   ``run_pipeline(dist=ctx)`` with the screen, rank 1
   ``tail_partition_worker``; its results, ``clusters`` and
   ``splitreads.break`` byte-identical to one process's ``run`` on the same
   inputs; each rank's backend, world size, device, seconds and stages;
   then ``dryrun_multichip(2)`` with both ranks on the card, its sharded
   real discover byte-identical to the one-process run, ``em_rows_kernel``
   launched on each rank.  Every rank is a
   child process with a limit; one that fails or runs over fails the
   phase;
14. routing: discover with the screen forced and off, alternated
   ROUTE_REPS times each in this process, at the bench dataset's shape and
   at the ``run``'s (phase 9's discover inputs), every run's artifacts the
   same bytes: wall and ``realign:emit`` (median, spread); discover once
   under ``auto`` with its ``[discover] screen:`` line; the verifier at
   each of phase 7's calls on the device and on the numpy oracle,
   alternated, counts equal in bounds, and once under ``auto``; the link
   (pageable copies at the screen's and the largest verify call's operand
   sizes, an empty launch's round trip); the cost models' rates fitted from
   these runs and phase 12's EM, each printed beside the constant in use;
   ``routing.routing_table()`` at the bench shapes; and each decision's
   route against the route measured faster: the phase fails only where the
   model picks the slower route by more than the measured spread.

All comparisons of the integer kernels are exact (tolerance 0); the EM
kernel's is stated in phase 12.  Each integer kernel's bound is the larger
of its least bytes over the card's memory rate and its least operations at
the probe's measured issue rates, the EM's its least fp64 operations at the
data sheet's rate (``em_bound``); the
verify's is printed for each of its shapes, beside the same bytes counted
in 32 B sectors.  Prints a line of each kernel's time, launches and bound,
a JSON line of the EM, multi-process and routing records, a JSON line of
per-kernel results (the verify's at shape B, the order the
main path sends, with all three shapes under ``shapes``), then
``{"ok": true, "device": ...}`` last.
"""

from __future__ import annotations

import contextlib
import json
import os
import pathlib
import subprocess
import sys
import tempfile
import time

import numpy as np
import torch

from defuse_tpu_torch.utils.profiling import cuda_time_ms as time_ms

REPO = pathlib.Path(__file__).resolve().parent
OUT = REPO / "build" / "smoke"  # SASS dumps and roofline.json
HBM_BYTES_PER_S = 3.35e12  # H100 SXM device memory rate (data sheet)
ACGT = np.frombuffer(b"ACGT", dtype=np.uint8)

# discover path's screen shape on the bench dataset: 46,953 candidate
# reads of 50 bp (L = 64), 96 flank pairs up to 220 bp (R = 256)
MAIN_B, MAIN_U, MAIN_R, MAIN_L, MAIN_READ, MAIN_FLANK = \
    46_953, 96, 256, 64, 50, 220
# tumour-library screen
SCALE_B, SCALE_U, SCALE_R, SCALE_L, SCALE_READ, SCALE_FLANK = \
    1 << 20, 4096, 512, 128, 100, 480
SCALE_SUB = 1 << 16
TRUE_FRACTION = 0.05
MIN_SIDE = 20


KERNEL_SOURCES = ("split_dp", "verify", "issue_probe", "em")


def timed_build(name):
    """(seconds, ptxas report) of building ``csrc/<name>.cu``."""
    from defuse_tpu_torch.ops import _build
    t0 = time.time()
    _path, report = _build.build(name)
    return time.time() - t0, report


def kernel_registers(report):
    """``kernel<template arguments> registers`` of each entry function in
    a ``ptxas -v`` report."""
    import re
    found = re.findall(
        r"Compiling entry function '\S*?\d+([a-z_]+_kernel)(?:I(\w*?)E)?E\S*' "
        r"for[^\n]*\n[^\n]*\n[^\n]*\n[^\n]*Used (\d+) registers", report)
    return "; ".join(
        f"{k}<{', '.join(re.findall(r'Li(\d+)', args or ''))}> {regs}"
        for k, args, regs in found)


def check(cond, msg):
    if not cond:
        raise RuntimeError(f"chip_smoke: {msg}")


def say(card, msg):
    print(f"[{card}] {msg}", flush=True)


@contextlib.contextmanager
def environ(**values):
    """``os.environ`` with ``values`` set, restored on the way out."""
    saved = {k: os.environ.get(k) for k in values}
    os.environ.update(values)
    try:
        yield
    finally:
        for k, v in saved.items():
            if v is None:
                os.environ.pop(k, None)
            else:
                os.environ[k] = v


def screen_launches_implied(outdir, launches, label):
    """The screen's launches of a discover into ``outdir`` are what its
    recorded ``screen_route`` says: one where the route was the device's,
    none where it was the host's.  Returns the route."""
    counters = json.loads((pathlib.Path(outdir) / "metrics.discover.json")
                          .read_text())["counters"]
    route = counters.get("screen_route")
    check(route is not None, f"{label}: no screen_route recorded")
    want = int(route["choice"] == "device")
    check(launches == want, f"{label}: {launches} screen launches, "
                            f"screen_route {route}")
    check(("split_dp_impl" in counters) == bool(want),
          f"{label}: split_dp_impl {counters.get('split_dp_impl')!r} with "
          f"screen_route {route}")
    return route


def check_no_reference_modules():
    """The port runs on its own: neither ``jax`` nor the JAX package nor
    the repository's bench and test helpers were imported."""
    bad = sorted(m for m in sys.modules
                 if m.split(".")[0] in ("jax", "defuse_tpu", "bench",
                                        "synthdata", "torch_cases"))
    check(not bad, f"imported {bad}")


def random_codes(rng, shape, lens):
    """ACGT codes (shape) with each row zero-padded past its length."""
    a = ACGT[rng.integers(0, 4, shape)]
    a[np.arange(shape[1])[None, :] >= np.asarray(lens)[:, None]] = 0
    return a


def reverse_rows(a, lens):
    """Each row reversed within its length (pad stays at the end)."""
    pos = np.asarray(lens)[:, None] - 1 - np.arange(a.shape[1])[None, :]
    out = np.take_along_axis(a, np.clip(pos, 0, a.shape[1] - 1), axis=1)
    out[pos < 0] = 0
    return out


# --- phase 3 ----------------------------------------------------------------

def sweep_case(rng, R, L, B=256, U=24):
    """Seeded instances at widths (R, L) with edge rows: zero-length reads
    and flanks, all-match reads and all-N reads against all-N flanks."""
    from defuse_tpu_torch.convert import screen_min_scores
    ref_lens = rng.integers(0, R + 1, B).astype(np.int32)
    read_lens = rng.integers(0, L + 1, B).astype(np.int32)
    ref_lens[:2] = R
    read_lens[:2] = L
    read_lens[2] = 0
    ref_lens[3] = 0
    refs = random_codes(rng, (B, R), ref_lens)
    reads = random_codes(rng, (B, L), read_lens)
    # all-match reads: a substring of the instance's own flank
    for b in range(4, B, 3):
        n = min(int(ref_lens[b]), int(read_lens[b]))
        s = int(rng.integers(0, ref_lens[b] - n + 1))
        reads[b, :n] = refs[b, s:s + n]
    # all-N rows: 'N' == 'N' scores as a match
    refs[5, :ref_lens[5]] = ord("N")
    reads[5, :read_lens[5]] = ord("N")
    reads[7, :read_lens[7]] = ord("N")

    ulen1 = rng.integers(0, R + 1, U).astype(np.int32)
    ulen2 = rng.integers(0, R + 1, U).astype(np.int32)
    ulen1[0] = ulen2[0] = R
    ulen1[1] = 0
    u1 = random_codes(rng, (U, R), ulen1)
    u2 = random_codes(rng, (U, R), ulen2)
    u1[2, :ulen1[2]] = ord("N")
    idx = rng.integers(0, U, B).astype(np.int32)
    sreads = reads.copy()
    for b in range(1, B, 2):  # planted junctions: flank1 tail + flank2 head
        k, n = int(idx[b]), int(read_lens[b])
        a = n // 2
        if ulen1[k] >= a and ulen2[k] >= n - a:
            sreads[b, :a] = u1[k, ulen1[k] - a:ulen1[k]]
            sreads[b, a:n] = u2[k, :n - a]
    screen = (u1, ulen1, reverse_rows(u2, ulen2), ulen2, idx, sreads,
              read_lens, screen_min_scores(read_lens))
    return (refs, ref_lens, reads, read_lens), screen


def tie_equals_plain(dev, arrays):
    """The tie kernel against its plain version on ``arrays`` (refs,
    ref_lens, reads, read_lens, row_sel) on the card: the max difference
    of the anchored maxima and of the packed words, and the plain result."""
    from defuse_tpu_torch.ops.split_dp_batch import dp_tie_columns
    from defuse_tpu_torch.ops.split_dp_cuda import dp_tie_columns_cuda
    ts = [torch.from_numpy(np.ascontiguousarray(a)).to(dev) for a in arrays]
    got, want = dp_tie_columns_cuda(*ts), dp_tie_columns(*ts)
    err = max(int((g.long() - w.long()).abs().max()) if w.numel() else 0
              for g, w in zip(got, want))
    return err, want


def phase_kernel_equals_plain(card, dev, rng):
    from defuse_tpu_torch.convert import screen_operands
    from defuse_tpu_torch.ops.split_dp_batch import (dp_row_maxima,
                                                     screen_candidates_ref)
    from defuse_tpu_torch.ops.split_dp_cuda import (dp_row_maxima_cuda,
                                                    screen_candidates)
    from defuse_tpu_torch.utils.synth import (EDGE_CASES, edge_case,
                                              sweep_inputs,
                                              tie_boundary_case, tie_rows)
    err_rowmax = err_screen = err_tie = 0
    shapes = ((60, 24), (90, 24), (100, 24), (130, 64), (128, 64),
              (257, 64), (384, 64), (512, 128))
    for R, L in shapes:
        rowmax_in, screen_in = sweep_case(rng, R, L)
        ts = [torch.from_numpy(a).to(dev) for a in rowmax_in]
        want = dp_row_maxima(*ts)
        got = dp_row_maxima_cuda(*ts)
        e = int((got - want).abs().max())
        # the same batch sorted by length: other pairs share each group
        order = torch.from_numpy(
            np.lexsort((rowmax_in[1], rowmax_in[3]))).to(dev)
        e = max(e, int((dp_row_maxima_cuda(*(t[order] for t in ts))
                        - want[order]).abs().max()))
        err_rowmax = max(err_rowmax, e)
        check(e == 0, f"rowmax kernel differs from plain at R={R} L={L}")
        e, (_max, packed) = tie_equals_plain(
            dev, (*rowmax_in, tie_rows(rowmax_in[3], L, 7, seed=R + L)))
        err_tie = max(err_tie, e)
        check(e == 0, f"tie kernel differs from plain at R={R} L={L}")
        check(bool(packed.any()), f"no tie column at R={R} L={L}")
        ops = screen_operands(*screen_in, dev)
        want = screen_candidates_ref(*ops)
        got = screen_candidates(*ops)
        e = int((got - want).abs().max())
        err_screen = max(err_screen, e)
        check(e == 0, f"screen kernel differs from plain at R={R} L={L}")
        check(int((want > 0).sum()) > 0, f"no survivor at R={R} L={L}")
    say(card, f"kernel == plain (exact): screen, rowmax (as made and sorted "
              f"by length) and tie columns at (R, L) = {shapes}")
    for name in sorted(EDGE_CASES):
        rowmax_in, screen_in = edge_case(name)
        ts = [torch.from_numpy(a).to(dev) for a in rowmax_in]
        e = int((dp_row_maxima_cuda(*ts) - dp_row_maxima(*ts)).abs().max())
        err_rowmax = max(err_rowmax, e)
        check(e == 0, f"rowmax kernel differs from plain on {name}")
        L = rowmax_in[2].shape[1]
        e, _want = tie_equals_plain(
            dev, (*rowmax_in, tie_rows(rowmax_in[3], L, 7, seed=len(name))))
        err_tie = max(err_tie, e)
        check(e == 0, f"tie kernel differs from plain on {name}")
        ops = screen_operands(*screen_in, dev)
        want = screen_candidates_ref(*ops)
        e = int((screen_candidates(*ops) - want).abs().max())
        err_screen = max(err_screen, e)
        check(e == 0, f"screen kernel differs from plain on {name}")
        check(int(want.max()) > 0, f"no survivor on {name}")
    # flanks whose last column sits on either side of a 32-column word
    arrays = tie_boundary_case()
    e, _want = tie_equals_plain(
        dev, (*arrays, tie_rows(arrays[3], arrays[2].shape[1], 7)))
    err_tie = max(err_tie, e)
    check(e == 0, "tie kernel differs from plain at the word boundaries")
    # 40 rows an instance: a group captures more rows than it keeps slots
    arrays = sweep_inputs(200, 64, seed=3, B=24)
    e, (_max, packed) = tie_equals_plain(
        dev, (*arrays, tie_rows(arrays[3], 64, 40, seed=9)))
    err_tie = max(err_tie, e)
    check(e == 0 and bool(packed.any()),
          "tie kernel differs from plain with 40 rows an instance")
    say(card, "kernel == plain (exact), all three, on the edge cases "
              f"{sorted(EDGE_CASES)}; tie columns with rows -1, 0, the "
              "read's last, past it, L and duplicates, flanks of 30-32 "
              "and 62-64 bases, and 40 rows an instance (two passes)")
    return err_rowmax, err_screen, err_tie


def screen_set(rng, B, U, R, L, read_len, max_flank, min_flank):
    """Candidate set: random decoy reads and TRUE_FRACTION junction reads
    (a flank1 substring then a flank2 substring, >= MIN_SIDE bases each).
    Returns (operands as numpy, true-junction mask)."""
    from defuse_tpu_torch.convert import screen_min_scores
    mean, sd = 0.625 * max_flank, 0.125 * max_flank
    ulen1 = np.clip(rng.normal(mean, sd, U), min_flank, max_flank) \
        .astype(np.int32)
    ulen2 = np.clip(rng.normal(mean, sd, U), min_flank, max_flank) \
        .astype(np.int32)
    u1 = random_codes(rng, (U, R), ulen1)
    u2 = random_codes(rng, (U, R), ulen2)
    idx = rng.integers(0, U, B).astype(np.int32)
    read_lens = np.full(B, read_len, dtype=np.int32)
    reads = random_codes(rng, (B, L), read_lens)

    true_mask = np.zeros(B, dtype=bool)
    t = rng.choice(B, int(B * TRUE_FRACTION), replace=False)
    true_mask[t] = True
    k = idx[t]
    a = rng.integers(MIN_SIDE, read_len - MIN_SIDE + 1, len(t))
    s1 = (rng.random(len(t)) * (ulen1[k] - a + 1)).astype(np.int64)
    s2 = (rng.random(len(t)) * (ulen2[k] - (read_len - a) + 1)) \
        .astype(np.int64)
    p = np.arange(read_len)[None, :]
    first = p < a[:, None]
    c1 = np.clip(s1[:, None] + p, 0, R - 1)
    c2 = np.clip(s2[:, None] + p - a[:, None], 0, R - 1)
    reads[t[:, None], p] = np.where(first, u1[k[:, None], c1],
                                    u2[k[:, None], c2])
    ops = (u1, ulen1, reverse_rows(u2, ulen2), ulen2, idx, reads, read_lens,
           screen_min_scores(read_lens))
    return ops, true_mask


def timed_screen(card, ops, true_mask, label, sub):
    """Kernel vs plain on the card: exact over the first ``sub``
    candidates, survivors == the planted junction reads, both timed.
    Returns (kernel ms for all, plain ms for ``sub``, max abs error, the
    screen's work: DP cells and least bytes)."""
    from defuse_tpu_torch.ops.split_dp_batch import screen_candidates_ref
    from defuse_tpu_torch.ops.split_dp_census import screen_cells
    from defuse_tpu_torch.ops.split_dp_cuda import screen_candidates
    B = ops[5].shape[0]
    kernel_ms = time_ms(lambda: screen_candidates(*ops), 10)
    sub_ops = ops[:4] + tuple(a[:sub].contiguous() for a in ops[4:])
    want = screen_candidates_ref(*sub_ops)
    got = screen_candidates(*sub_ops)
    err = int((got - want).abs().max())
    check(err == 0, f"{label}: kernel differs from plain")
    plain_ms = time_ms(lambda: screen_candidates_ref(*sub_ops), 2)
    say(card, f"{label}: kernel {kernel_ms:.3f} ms for {B} candidates "
              f"({B / kernel_ms * 1e3:.0f} candidates/s); plain "
              f"{plain_ms:.3f} ms for {sub} ({sub / plain_ms * 1e3:.0f} "
              "candidates/s)")
    survivors = (screen_candidates(*ops) > 0).cpu().numpy()
    check(np.array_equal(survivors, true_mask),
          f"{label}: survivors {int(survivors.sum())} != planted junction "
          f"reads {int(true_mask.sum())} (mismatches "
          f"{int((survivors != true_mask).sum())})")
    say(card, f"{label}: survivors == {int(true_mask.sum())} planted "
              "junction reads")
    work = {"candidates": B, "cells": screen_cells(ops[1], ops[3], ops[4],
                                                   ops[6]),
            "bytes": sum(t.numel() * t.element_size() for t in ops) + 4 * B}
    return kernel_ms, plain_ms, err, work


def phase_main_shape(card, dev, rng):
    from defuse_tpu_torch.convert import screen_operands
    ops_np, true_mask = screen_set(rng, MAIN_B, MAIN_U, MAIN_R, MAIN_L,
                                   MAIN_READ, MAIN_FLANK, 120)
    ops = screen_operands(*ops_np, dev)
    return timed_screen(card, ops, true_mask,
                        f"screen at discover shape (R={MAIN_R}, L={MAIN_L})",
                        MAIN_B)


# --- phase 4 ----------------------------------------------------------------

def phase_scale(card, dev, rng):
    from defuse_tpu_torch.convert import screen_operands
    t0 = time.time()
    ops_np, true_mask = screen_set(rng, SCALE_B, SCALE_U, SCALE_R, SCALE_L,
                                   SCALE_READ, SCALE_FLANK, 120)
    t1 = time.time()
    ops = screen_operands(*ops_np, dev)
    torch.cuda.synchronize()
    t2 = time.time()
    say(card, f"scale set: make {t1 - t0:.2f} s, upload {t2 - t1:.3f} s "
              f"(reads {ops[5].numel() / 2**20:.0f} MiB, flanks "
              f"{2 * ops[0].numel() / 2**20:.1f} MiB)")
    return timed_screen(card, ops, true_mask,
                        f"screen at scale (R={SCALE_R}, L={SCALE_L})",
                        SCALE_SUB)


# --- phase 5 ----------------------------------------------------------------

ARTIFACTS = ("clusters", "clusters.sc", "clusters.sc.regions",
             "splitreads.alignments", "splitreads.seq", "splitreads.break",
             "splitreads.predalign")


def discover_kwargs(paths):
    from defuse_tpu_torch.utils import synth
    return dict(spanning=str(paths["spanning"]),
                improper=str(paths["improper"]),
                fastq1=str(paths["fastq1"]), fastq2=str(paths["fastq2"]),
                reference=str(paths["reference"]), exons=str(paths["exons"]),
                fragment_mean=synth.MEAN, fragment_stddev=synth.STD,
                precision=synth.PREC, min_cluster_size=synth.MINCL,
                min_read_length=synth.MINREAD,
                max_read_length=synth.MAXREAD)


def bench_dataset(card, work):
    from defuse_tpu_torch.utils import synth
    t0 = time.time()
    ds, paths, n_pairs = synth.build_dataset(work)
    say(card, f"bench dataset: {n_pairs} read pairs in "
              f"{time.time() - t0:.2f} s")
    return ds, paths, n_pairs


def phase_end_to_end(card, work, dataset):
    from defuse_tpu_torch.ops import split_dp_cuda
    from defuse_tpu_torch.pipeline.discover import discover_fusions

    _ds, paths, n_pairs = dataset
    kw = discover_kwargs(paths)
    t0 = time.time()
    discover_fusions(outdir=str(work / "host"), use_device=False, **kw)
    t_host = time.time() - t0

    split_dp_cuda.reset_launches()
    t0 = time.time()
    with environ(DEFUSE_DEVICE_SCREEN="force"):
        discover_fusions(outdir=str(work / "port"), device="cuda", **kw)
    t_port = time.time() - t0
    launches = dict(split_dp_cuda.LAUNCHES)

    for name in ARTIFACTS:
        a = (work / "host" / name).read_bytes()
        b = (work / "port" / name).read_bytes()
        check(a == b, f"{name} differs from the host-only run")
    metrics = json.loads((work / "port" / "metrics.discover.json")
                         .read_text())
    counters = metrics["counters"]
    check(counters.get("split_dp_impl") == "cuda",
          f"split_dp_impl is {counters.get('split_dp_impl')!r}")
    check(launches["split_dp_screen"] > 0, "screen kernel never launched")
    check_no_reference_modules()
    check(len((work / "port" / "splitreads.seq").read_bytes()) > 0,
          "no fusion sequences produced")
    stages = " ".join(f"{s['stage'].removeprefix('discover:')}="
                      f"{s['seconds']}" for s in metrics["stages"])
    say(card, f"discover: port, screen forced, {t_port:.3f} s "
              f"({n_pairs / t_port:.0f} pairs/s), host-only run (no screen) "
              f"{t_host:.3f} s; "
              f"{len(ARTIFACTS)} artifacts byte-identical")
    say(card, f"discover stages (s): {stages}")
    say(card, f"screen: {int(counters['screen_candidates'])} candidates, "
              f"{int(counters['screen_survivors'])} survivors, "
              f"launches {launches}")
    return launches


# --- phase 6 ----------------------------------------------------------------

# A and B: the verify microbench (4,000,000 bases, 20,000 reads of 50 bp)
VERIFY_N, VERIFY_READS, VERIFY_READ = 4_000_000, 20_000, 50
VERIFY_BATCHES = (65_536, 524_288)
# C: a genome's plane (3.1e9 bases, 1.24 GB), 1,048,576 reads of 100 bp, 8
# candidates a read; the plain version runs on the first GENOME_BATCHES[0]
GENOME_READ = 100
GENOME_BATCHES = (1 << 20, 1 << 23)
# a read length for each kernel: 8, 16 and 32 lanes a candidate (both ends
# of each range) and a warp walking the row
VERIFY_EDGE_LENGTHS = (1, 50, 53, 70, 71, 100, 150, 151, 310, 311, 700)


def verify_shape(rng):
    """The microbench's inputs as numpy (codes, starts, reads, read_idx,
    read_lens): VERIFY_BATCHES[-1] candidates, ``read_idx`` drawn at
    random (shape A; sorted by (read, start) they are shape B)."""
    codes = rng.integers(0, 4, VERIFY_N).astype(np.int8)
    reads = rng.integers(0, 4, (VERIFY_READS, VERIFY_READ)).astype(np.int8)
    lens = np.full(VERIFY_READS, VERIFY_READ, np.int32)
    C = VERIFY_BATCHES[-1]
    starts = rng.integers(0, VERIFY_N - VERIFY_READ, C)
    ridx = rng.integers(0, VERIFY_READS, C).astype(np.int32)
    return codes, starts, reads, ridx, lens


def first(ops, c):
    """The operands of the first ``c`` candidates."""
    ref3, w10, l10, reads3, ridx, lens = ops
    return ref3, w10[:c], l10[:c], reads3, ridx[:c], lens


def verify_at_shape(card, name, ops, L, counts, n_check, exact_hits=False):
    """Kernel = plain version on the first ``n_check`` candidates (which
    hold mismatches and, where ``exact_hits``, exact matches), then the
    kernel, its two legs and the plain version timed at the two candidate
    counts.  Returns the shape's record: times, marginals and the work of
    both counts."""
    from defuse_tpu_torch.ops.verify_batch import verify_packed3_ref
    from defuse_tpu_torch.ops.verify_cuda import verify_packed3
    from defuse_tpu_torch.ops.verify_roofline import legs_ms, verify_work

    sub = first(ops, n_check)
    want = verify_packed3_ref(*sub, L)
    err = int((verify_packed3(*ops, L)[:n_check] - want).abs().max())
    hits = int((want == 0).sum())
    check(err == 0, f"verify {name}: kernel differs from plain")
    check(int(want.max()) > 0 and (hits > 0 or not exact_hits),
          f"verify {name}: no mismatch or no exact match checked")
    del want
    legs = legs_ms(ops, L, counts)
    plain_counts = [c for c in counts if c <= n_check]
    plain = {c: time_ms(lambda c=c: verify_packed3_ref(*first(ops, c), L), 2)
             for c in plain_counts}
    rec = {"L": L, "counts": list(counts), "checked": n_check,
           "exact_hits_checked": hits, "err": err,
           "legs": legs, "ms": legs["full"]["ms"][1],
           "plain_ms": plain[plain_counts[-1]],
           "plain_candidates": plain_counts[-1],
           "work": [verify_work(*first(ops, c)) for c in counts]}
    say(card, f"verify {name}: kernel == plain (exact) on {n_check} "
              f"candidates ({hits} of them exact matches); kernel {legs['full']['ms'][1]:.4f} ms for "
              f"{counts[1]} candidates, {legs['full']['ms'][0]:.4f} ms for "
              f"{counts[0]}; marginal ns a candidate: full "
              f"{legs['full']['marginal_ns']:.4f}, gather "
              f"{legs['gather']['marginal_ns']:.4f}, compute "
              f"{legs['compute']['marginal_ns']:.4f}; legs at {counts[1]}: "
              f"gather {legs['gather']['ms'][1]:.4f} ms, compute "
              f"{legs['compute']['ms'][1]:.4f} ms; plain "
              f"{rec['plain_ms']:.3f} ms for {rec['plain_candidates']}")
    return rec


def phase_verify(card, dev, rng):
    from defuse_tpu_torch.convert import verify_operands
    from defuse_tpu_torch.ops.verify_batch import verify_packed3_ref
    from defuse_tpu_torch.ops.verify_cuda import group_lanes, verify_packed3
    from defuse_tpu_torch.ops.verify_roofline import verify_leg
    from defuse_tpu_torch.utils.synth import verify_case, verify_genome_case

    lanes = {}
    for L in VERIFY_EDGE_LENGTHS:
        codes, starts, reads, ridx, lens = verify_case(
            int(rng.integers(1 << 30)), L=L)
        ops = verify_operands(codes, starts, reads, ridx, lens, dev)
        want = verify_packed3_ref(*ops, L)
        e = int((verify_packed3(*ops, L) - want).abs().max())
        check(e == 0, f"verify kernel differs from plain on the edge cases "
                      f"at L={L}")
        check(int(want.max()) > 0 and int((want == 0).sum()) > 0,
              "edge cases hold no mismatch or no exact match")
        cpu = tuple(t.cpu() for t in ops)
        for leg in ("gather", "compute"):
            check(torch.equal(verify_leg(leg, *ops, L).cpu(),
                              verify_leg(leg, *cpu, L)),
                  f"verify {leg} leg differs from its plain version at L={L}")
        lanes[L] = group_lanes(L)
    say(card, f"verify kernel and both legs == plain (exact) on "
              f"{len(starts)} edge-case candidates at each L: lanes a "
              f"candidate {lanes} (0: a warp walks the row)")

    shapes = {}
    codes, starts, reads, ridx, lens = verify_shape(rng)
    by = np.lexsort((starts, ridx))  # (read, start): SeedIndex.candidates
    for name, order in (("A", slice(None)), ("B", by)):
        ops = verify_operands(codes, starts[order], reads, ridx[order], lens,
                              dev)
        shapes[name] = verify_at_shape(card, name, ops, VERIFY_READ,
                                       VERIFY_BATCHES, VERIFY_BATCHES[-1])
    del ops

    t0 = time.time()
    ops, is_source, planted = verify_genome_case(dev, seed=2024)
    torch.cuda.synchronize()
    say(card, f"verify C: plane of {ops[0].numel()} words "
              f"({ops[0].numel() * 4 / 1e9:.2f} GB), {ops[3].shape[0]} reads "
              f"of {GENOME_READ} bp, {ops[1].numel()} candidates made on the "
              f"card in {time.time() - t0:.2f} s")
    check(ops[1].numel() == GENOME_BATCHES[-1], "genome case: candidates")
    got = verify_packed3(*ops, GENOME_READ)
    check(torch.equal(got[is_source].long(),
                      planted[ops[4].long()[is_source]]),
          "verify C: a read's source window does not get its planted "
          "mismatches")
    say(card, f"verify C: {int(is_source.sum())} source windows get their "
              f"planted mismatches (0..3: "
              f"{torch.bincount(planted, minlength=4).tolist()} reads)")
    del got
    shapes["C"] = verify_at_shape(card, "C", ops, GENOME_READ,
                                  GENOME_BATCHES, GENOME_BATCHES[0],
                                  exact_hits=True)
    say(card, f"peak device memory in the verify phase: "
              f"{torch.cuda.max_memory_allocated() / 1e9:.2f} GB")
    return max(r["err"] for r in shapes.values()), shapes


def verify_bounds(card, shapes, alu_ns):
    """Each shape's bound (at its larger count and for the marginal
    candidate) beside its times; fills the records in."""
    from defuse_tpu_torch.ops.verify_roofline import verify_ops_ms
    for name, rec in shapes.items():
        small, big = rec["work"]
        rec["bound_ms"], rec["bound_by"] = bound(
            big["bytes"], verify_ops_ms(big["words"], alu_ns))
        dc = big["candidates"] - small["candidates"]
        marginal_ms, by = bound(
            big["bytes"] - small["bytes"],
            verify_ops_ms(big["words"] - small["words"], alu_ns))
        rec["marginal_bound_ns"] = marginal_ms * 1e6 / dc
        full = rec["legs"]["full"]["marginal_ns"]
        say(card, f"verify {name} ({big['candidates']} candidates, L "
                  f"{rec['L']}): {rec['ms']:.4f} ms, bound "
                  f"{rec['bound_ms']:.4f} ms by {rec['bound_by']} "
                  f"({100 * rec['bound_ms'] / rec['ms']:.1f}% of bound; "
                  f"{big['bytes']} B least, {big['sector_bytes']} B in 32 B "
                  f"sectors with no cache); marginal {full:.4f} ns a "
                  f"candidate, bound {rec['marginal_bound_ns']:.4f} ns by "
                  f"{by} ({100 * rec['marginal_bound_ns'] / full:.1f}%)")


# --- phase 7 ----------------------------------------------------------------

FRONTEND_ARTIFACTS = ("spanning", "improper", "concordant_sam",
                      "pair_table")


def frontend_bytes(res):
    """Each artifact's bytes, the concordant SAM decompressed (its gzip
    members differ between routes)."""
    import gzip
    out = {}
    for key in FRONTEND_ARTIFACTS:
        path = res[key]
        check(path is not None, f"frontend wrote no {key}")
        out[key] = gzip.open(path).read() if path.endswith(".gz") \
            else pathlib.Path(path).read_bytes()
    return out


def phase_frontend(card, work, dataset):
    import os

    from defuse_tpu_torch.align import frontend
    from defuse_tpu_torch.align.frontend import align_reads
    from defuse_tpu_torch.ops import verify_batch, verify_cuda
    from defuse_tpu_torch.utils.synth import frontend_config

    ds, paths, n_pairs = dataset
    config = frontend_config(ds, work / "refs")
    fq = (str(paths["fastq1"]), str(paths["fastq2"]))
    t0 = time.time()  # builds and persists the seed indices
    align_reads(config, str(work / "fe_warm"), *fq, device="cuda")
    t_index = time.time() - t0
    t0 = time.time()
    native = align_reads(config, str(work / "fe_native"), *fq, device="cuda")
    t_native = time.time() - t0

    calls = []  # the verifier's operands, call by call, for phase 14
    verify = verify_batch.DeviceVerifier.__call__

    def recorded(self, *ops):
        calls.append(ops)
        return verify(self, *ops)

    verify_cuda.reset_launches()
    verify_batch.DeviceVerifier.__call__ = recorded
    try:
        with environ(DEFUSE_DEVICE_VERIFY="force"):
            t0 = time.time()
            forced = align_reads(config, str(work / "fe_device"), *fq,
                                 device="cuda")
            t_device = time.time() - t0
    finally:
        verify_batch.DeviceVerifier.__call__ = verify
    launches = dict(verify_cuda.LAUNCHES)
    check(frontend.VERIFY_CALLS == {"device": len(calls), "host": 0}
          and launches["verify_packed3"] == len(calls),
          f"frontend: verifier calls {frontend.VERIFY_CALLS}, "
          f"{len(calls)} recorded, launches {launches}")

    a, b = frontend_bytes(native), frontend_bytes(forced)
    for key in FRONTEND_ARTIFACTS:
        check(a[key] == b[key], f"frontend {key} differs between the "
                                "native and the forced-device route")
    check(len(a["improper"]) > 0 and len(a["spanning"]) > 0,
          "frontend wrote no discordant alignments")
    check(launches["verify_packed3"] > 0, "verify kernel never launched")
    check_no_reference_modules()
    say(card, f"frontend on {n_pairs} pairs: forced device verify "
              f"{t_device:.3f} s ({n_pairs / t_device:.0f} pairs/s), native "
              f"route {t_native:.3f} s ({n_pairs / t_native:.0f} pairs/s); "
              f"first run with index build {t_index:.3f} s; "
              f"{len(FRONTEND_ARTIFACTS)} artifacts byte-identical "
              f"(improper {len(a['improper'])} B, spanning "
              f"{len(a['spanning'])} B); launches {launches}: one for each "
              "call of the verifier that had candidates")
    say(card, "frontend verifier calls (candidates, reads, L): " + ", ".join(
        f"({len(c[1])}, {c[2].shape[0]}, {c[2].shape[1]})" for c in calls))
    return launches, calls


# --- phase 8 ----------------------------------------------------------------

PROBE_CHECK_ITERS = 256


def class_row(counts):
    return " ".join(f"{k}={v:g}" for k, v in counts.items())


def phase_probe_equals_plain(card, dev):
    from defuse_tpu_torch.ops import split_dp_census as sc
    seed = sc.probe_seed(dev)
    err = 0
    kernel_ms = plain_ms = 0.0
    for mix in sc.MIXES:
        want = sc.issue_probe_ref(seed, PROBE_CHECK_ITERS, mix)
        got = sc.issue_probe(seed, PROBE_CHECK_ITERS, mix)
        e = int((got - want).abs().max())
        check(e == 0, f"issue probe {mix} differs from plain")
        err = max(err, e)
        kernel_ms += time_ms(
            lambda: sc.issue_probe(seed, PROBE_CHECK_ITERS, mix), 5)
        plain_ms += time_ms(
            lambda: sc.issue_probe_ref(seed, PROBE_CHECK_ITERS, mix), 1)
    say(card, f"issue probe == plain (exact) for mixes {sc.MIXES}, "
              f"{seed.shape[0]} threads x {PROBE_CHECK_ITERS} steps: kernel "
              f"{kernel_ms:.3f} ms, plain {plain_ms:.3f} ms (all mixes)")
    work = {"warps": seed.shape[0] // sc.WARP, "steps": PROBE_CHECK_ITERS,
            "bytes": 2 * len(sc.MIXES) * seed.numel() * seed.element_size()}
    return err, kernel_ms, plain_ms, work


def verify_sass_sizes(text):
    """``{"<lanes, leg>": instructions}`` of the verify's group kernels in a
    ``cuobjdump -sass`` dump."""
    import re
    sizes = {}
    for body in text.split("Function : ")[1:]:
        m = re.match(r"\S*verify_group_kernelILi(\d+)ELi(\d)E", body)
        if m:
            sizes[f"<{m[1]}, {m[2]}>"] = len(re.findall(
                r"^\s+/\*[0-9a-f]{4}\*/\s+\S", body, re.M))
    return dict(sorted(sizes.items()))


def phase_sass(card):
    from defuse_tpu_torch.ops import _build
    from defuse_tpu_torch.ops import split_dp_census as sc

    OUT.mkdir(parents=True, exist_ok=True)
    bad = []
    text = _build.sass("issue_probe")
    (OUT / "issue_probe.sass").write_text(text)
    loops = sc.probe_loops(text)
    for mix in sc.MIXES:
        check(mix in loops, f"no loop found in the probe's {mix} kernel")
        lp = loops[mix]
        want = sc.mix_census(mix)
        say(card, f"SASS probe {mix} loop trip: {class_row(lp['counts'])}; "
                  f"census {class_row(want)}; opcodes {lp['opcodes']}")
        bad += [f"probe {mix} {m}" for m in
                sc.census_mismatches(want, lp["counts"])]
    text = _build.sass("verify")
    (OUT / "verify.sass").write_text(text)
    say(card, "SASS verify, static instructions of verify_group_kernel<lanes, "
              f"leg> (0 full, 1 gather, 2 compute): {verify_sass_sizes(text)}; "
              "<8, leg> is straight-line code, so its count is a warp's "
              "instructions for 32 candidates")
    text = _build.sass("split_dp")
    (OUT / "split_dp.sass").write_text(text)
    lib = _build.load("split_dp")
    for R in (1, 127, 128, 287, 288, 511, 512, 1023, 1024):
        check(lib.split_dp_lanes(R) == sc.shape_for(R)[0],
              f"split_dp_lanes({R}) differs from the census's shape_for")
    shapes = sorted({sc.shape_for(R) for R in range(1, 1024)})
    for kernel in ("screen_kernel", "rowmax_kernel"):
        rows = sc.row_loops(text, kernel)
        check(sorted(rows) == shapes,
              f"{kernel}s in the SASS {sorted(rows)}, expected {shapes}")
        for lanes, cmax in shapes:
            # one row loop per column count of the kernel's switch
            found = rows[lanes, cmax]
            check(sorted(found) == list(range(1, cmax + 1)),
                  f"{kernel}<{cmax}, {lanes}>: row loops for C = "
                  f"{sorted(found)}, expected 1..{cmax}")
            for C, lp in sorted(found.items()):
                want = sc.row_census(C, lanes, cmax, kernel)["total"]
                flush = sc.flush_census(lanes)["static"]
                want = {k: want[k] + flush[k] for k in sc.CLASSES}
                miss = sc.census_mismatches(want, lp["per_row"])
                bad += [f"{kernel}<{cmax}, {lanes}> C={C} {m}" for m in miss]
                if miss or C in (1, cmax):
                    say(card, f"SASS {kernel}<{cmax}, {lanes}> C={C} row "
                              f"loop ({lp['rows_per_trip']} row per trip, "
                              f"{lp['nested']} nested): "
                              f"{class_row(lp['per_row'])}; census (row + "
                              f"the flush's static part) {class_row(want)}; "
                              f"opcodes {lp['opcodes']}")
    check(not bad, "census differs from the machine code by more than "
                   f"{sc.TOLERANCE:.0%}: " + "; ".join(bad))
    say(card, "census within 20% of the SASS in every class of every loop")


def phase_roofline(card, dev):
    import subprocess
    from defuse_tpu_torch.ops import split_dp_census as sc

    sc.reset_launches()
    roof = sc.screen_roofline(dev)
    launches = dict(sc.LAUNCHES)
    check(launches["issue_probe"] > 0, "issue probe never launched")
    clocks = subprocess.run(
        ["nvidia-smi", "--query-gpu=clocks.sm,clocks.max.sm",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60).stdout.strip()
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    mhz = float(clocks.split(",")[0].split()[0])
    probe = roof["probe"]
    for mix, m in probe["mixes"].items():
        say(card, f"probe {mix}: {m['ns_per_step']:.4f} ns/step "
                  f"(t {m['t_small_ms']:.3f} / {m['t_big_ms']:.3f} ms at "
                  f"{probe['iters']} steps), {m['warp_instr_per_ns']:.2f} "
                  f"warp instr/ns = {m['warp_instr_per_ns'] * 1e3 / mhz / sms:.3f}"
                  f" per SM per clock")
    for label, cost in (("32-bit", probe["ns_per_warp_instr"]),
                        ("16x2", probe["ns_per_warp_instr_16x2"])):
        say(card, f"cost per warp instruction, {label} (card-wide ns): " +
            " ".join(f"{k}={v:.3e} ({1e3 / v / mhz / sms:.3f}/SM/clk)"
                     for k, v in cost.items()))
    say(card, f"clocks.sm, clocks.max.sm after the probe: {clocks}; "
              f"{sms} SMs")
    census = roof["census"]
    say(card, f"screen roofline (R={roof['R']}, L={roof['L']}, "
              f"{roof['read_len']} bp, B={roof['batches']}, "
              f"{roof['batch_ms']} ms): measured "
              f"{roof['measured_us_per_read']:.5f} us/candidate; bound "
              f"{roof['bound_us_per_read']:.5f} us/candidate "
              f"({roof['cells_per_read']} cells, two to a register; "
              f"{roof['bound32_us_per_read']:.5f} in int32): "
              f"{roof['pct_of_bound']:.1f}% of bound; census ceiling "
              f"{roof['ceiling_us_per_read']:.5f} us/candidate, "
              f"{roof['pct_of_ceiling']:.1f}% of ceiling; census per "
              f"candidate {census['per_candidate']} "
              f"({census['lanes']} lanes, C={census['cols_per_lane']}, "
              f"{census['rows']} rows)")
    say(card, f"probe launches {launches}")
    (OUT / "roofline.json").write_text(
        json.dumps(roof, indent=1))
    return launches, probe


# --- phase 9 ----------------------------------------------------------------

IMPL = {"cuda": "cuda", "cpu": "torch"}  # metrics' split_dp_impl by device
RUN_ARTIFACTS = ("results.tsv", "results.classify.tsv",
                 "results.filtered.tsv", "annotations",
                 "concordant.read.stats") + ARTIFACTS
RUN_STAGES = ("frontend", "read stats", "covariance samples", "discover",
              "pvalues", "breakseq", "annotation", "denovo",
              "collate+classify")


def raw_fastqs(work):
    """The bench dataset's fastqs as ``write_dataset`` wrote them (the
    renamed copies under ``ing/`` are the discover phase's)."""
    return str(work / "reads.1.fastq"), str(work / "reads.2.fastq")


class StageClock:
    """Wall seconds of the stages that write no metrics of their own: the
    frontend (``align_reads``) and the Runner's stages (read stats, calccov),
    timed from outside while a ``run`` goes through the command line; and
    the keyword arguments of its ``discover_fusions`` call
    (``discover_kw``)."""

    def __enter__(self):
        from defuse_tpu_torch.align import frontend
        from defuse_tpu_torch.pipeline.runner import Runner
        from defuse_tpu_torch.pipeline import run as run_module
        self.seconds = {}
        self.discover_kw = None
        self._saved = (frontend.align_reads, Runner.run,
                       run_module.discover_fusions)
        align_reads, run, discover = self._saved

        def kept_discover(**kw):
            self.discover_kw = dict(kw)
            return discover(**kw)

        def timed_align(*args, **kw):
            t0 = time.time()
            try:
                return align_reads(*args, **kw)
            finally:
                self.seconds["frontend"] = time.time() - t0

        def timed_run(runner, name, *args, **kw):
            t0 = time.time()
            try:
                return run(runner, name, *args, **kw)
            finally:
                self.seconds[name] = time.time() - t0

        frontend.align_reads, Runner.run = timed_align, timed_run
        run_module.discover_fusions = kept_discover
        return self

    def __exit__(self, *exc):
        from defuse_tpu_torch.align import frontend
        from defuse_tpu_torch.pipeline import run as run_module
        from defuse_tpu_torch.pipeline.runner import Runner
        (frontend.align_reads, Runner.run,
         run_module.discover_fusions) = self._saved

    def stages(self, out):
        """This clock's stages and those of the run's ``metrics.json``."""
        both = dict(self.seconds) | {s["stage"]: s["seconds"] for s in
                                     json.loads((out / "metrics.json")
                                                .read_text())["stages"]}
        return {k: round(both[k], 3) for k in RUN_STAGES if k in both}


def phase_run(card, work, dataset, device):
    from defuse_tpu_torch.cli.main import main as cli
    from defuse_tpu_torch.ops import split_dp_cuda, verify_cuda
    from defuse_tpu_torch.utils import synth

    ds, _paths, n_pairs = dataset
    config = str(synth.write_run_config(ds, work / "run_refs"))
    data = str(work / "run_dataset")
    t0 = time.time()
    check(cli(["create-ref", "-c", config, "-d", data]) == 0, "create-ref")
    t_ref = time.time() - t0
    fq1, fq2 = raw_fastqs(work)
    common = ["run", "-c", config, "-d", data, "-1", fq1, "-2", fq2,
              "-n", "smoke"]

    split_dp_cuda.reset_launches()
    verify_cuda.reset_launches()
    t0 = time.time()
    with StageClock() as card_clock:
        check(cli(common + ["-o", str(work / "run_card"), "--device",
                            device]) == 0, "run on the card")
    t_card = time.time() - t0
    launches = dict(split_dp_cuda.LAUNCHES) | dict(verify_cuda.LAUNCHES)
    t0 = time.time()
    with StageClock() as host_clock:
        check(cli(common + ["-o", str(work / "run_host"), "--no-device"])
              == 0, "run --no-device")
    t_host = time.time() - t0

    for name in RUN_ARTIFACTS:
        a = (work / "run_card" / name).read_bytes()
        check(a == (work / "run_host" / name).read_bytes(),
              f"run: {name} differs between the card and --no-device")
        check(len(a) > 0, f"run: {name} is empty")
    counters = json.loads((work / "run_card" / "metrics.discover.json")
                          .read_text())["counters"]
    route = screen_launches_implied(work / "run_card",
                                    launches["split_dp_screen"], "run")
    check(counters.get("split_dp_impl", IMPL[device]) == IMPL[device],
          f"run: split_dp_impl is {counters.get('split_dp_impl')!r}")
    rows = [r.split("\t") for r in (work / "run_card" /
            "results.classify.tsv").read_text().splitlines()]
    g1, g2 = rows[0].index("gene1"), rows[0].index("gene2")
    found = {frozenset((r[g1], r[g2])) for r in rows[1:]}
    planted = synth.planted_pairs(ds)
    missing = sorted(tuple(sorted(p)) for p in planted - found)
    check(not missing, f"run: planted fusions not called: {missing}")
    n_filtered = len((work / "run_card" / "results.filtered.tsv")
                     .read_text().splitlines()) - 1
    check_no_reference_modules()
    say(card, f"run on {n_pairs} pairs: card {t_card:.3f} s "
              f"({n_pairs / t_card:.0f} pairs/s), --no-device {t_host:.3f} "
              f"s; create-ref {t_ref:.3f} s; {len(RUN_ARTIFACTS)} artifacts "
              f"byte-identical; {len(planted)}/{len(planted)} planted gene "
              f"pairs among {len(rows) - 1} classified rows, {n_filtered} "
              f"past the probability threshold; launches {launches}; "
              f"screen_route {route}; screen survivors "
              f"{counters.get('screen_survivors', 'none: not screened')}")
    say(card, "run stages on the card (s): "
              f"{card_clock.stages(work / 'run_card')}")
    say(card, "run stages --no-device (s): "
              f"{host_clock.stages(work / 'run_host')}")
    return launches, card_clock.discover_kw


# --- phase 10 ---------------------------------------------------------------

NO_NATIVE_FUSIONS, NO_NATIVE_BACKGROUND = 12, 3000


NO_NATIVE_OUT = {"oracle": "no_native", "device": "no_native_device_em"}


def kernel_times(fn, plain, reps):
    """The kernel alone (``reps`` launches replayed from one CUDA graph, no
    host time between them), the whole wrapper call (``reps`` calls back
    to back) and the plain version, in ms."""
    return {"ms": time_ms(fn, reps, graph=True), "call_ms": time_ms(fn, reps),
            "plain_ms": time_ms(plain, 2)}


def no_native_child(work, device, em_mode):
    """Phase 10's child process (``DEFUSE_NO_NATIVE=1``): discover on the
    cut dataset under ``work`` through the Python realign, the row maxima
    and tie columns on ``device``, and the EM that ``em_mode`` names: the
    Python oracle, or the batched EM on ``device``.  Prints one JSON line.
    Each kernel's wrapper is called as often as it launches, and no plain
    version runs on a CUDA tensor.  For the oracle: both kernels against
    their plain versions and timed on the route's own operands, and the
    tie columns on ``device`` against the same call on CPU tensors.  For
    the batched EM: what ``metrics.discover.json`` says of it."""
    from defuse_tpu_torch.cluster import matepair_em_batch as em
    from defuse_tpu_torch.cluster import native
    from defuse_tpu_torch.ops import em_cuda, split_dp_batch, split_dp_cuda
    from defuse_tpu_torch.ops.split_dp_census import census_rowmax
    from defuse_tpu_torch.pipeline import discover
    check(not native.available(), "the child has the native library")
    paths = {k: work / v for k, v in (
        ("spanning", "spanning.compact"), ("improper", "improper.sam"),
        ("fastq1", "reads.1.fastq"), ("fastq2", "reads.2.fastq"),
        ("reference", "reference.fa"), ("exons", "cdna.regions"))}
    seen = {"rowmax": [], "tie": [], "plain_on_card": 0}
    rowmax, tie = discover.dp_row_maxima_cuda, split_dp_cuda.dp_tie_columns_cuda
    plain = {n: getattr(split_dp_batch, n)
             for n in ("dp_row_maxima", "dp_tie_columns")}
    discover.dp_row_maxima_cuda = \
        lambda *ops: seen["rowmax"].append(ops) or rowmax(*ops)
    split_dp_cuda.dp_tie_columns_cuda = \
        lambda *ops: seen["tie"].append(ops) or tie(*ops)

    def watched(name):
        def call(*ops):
            seen["plain_on_card"] += ops[0].device.type != "cpu"
            return plain[name](*ops)
        return call
    for name in plain:
        setattr(split_dp_batch, name, watched(name))
    split_dp_cuda.reset_launches()
    em_cuda.reset_launches()
    outdir = work / NO_NATIVE_OUT[em_mode]
    t0 = time.time()
    discover.discover_fusions(outdir=str(outdir), device=device,
                              em_mode=em_mode, **discover_kwargs(paths))
    seconds = time.time() - t0
    launches = dict(split_dp_cuda.LAUNCHES) | em_cuda.LAUNCHES
    for name, fn in plain.items():
        setattr(split_dp_batch, name, fn)
    check(len(seen["rowmax"]) == 1 and len(seen["tie"]) == 1,
          f"route called rowmax {len(seen['rowmax'])} and dp_tie_columns "
          f"{len(seen['tie'])} times")
    if device == "cuda":
        check(launches["split_dp_rowmax"] == 1
              and launches["split_dp_tie_columns"] == 1,
              f"route launched {launches} for 1 rowmax and 1 tie call")
        check(seen["plain_on_card"] == 0,
              f"a plain version ran {seen['plain_on_card']} times on the card")
    check_no_reference_modules()
    if em_mode == "device":
        if device == "cuda":
            check(launches["em_rows_kernel"] > 0,
                  "em_mode=device: em_rows_kernel never launched")
            check(em.PLAIN_RUNS["cuda"] == 0,
                  f"the plain EM ran {em.PLAIN_RUNS['cuda']} times on the "
                  "card")
        print(json.dumps({"seconds": seconds, "launches": launches,
                          "plain_em_on_card": em.PLAIN_RUNS["cuda"]}),
              flush=True)
        return 0

    ops = seen["rowmax"][0]
    want = plain["dp_row_maxima"](*ops)
    err = int((rowmax(*ops) - want).abs().max())
    check(int(want.max()) > 0, "no-native: no row clears the anchor")
    ref_lens, read_lens = (t.cpu().numpy().astype(np.int64)
                           for t in (ops[1], ops[3]))
    rec = {"seconds": seconds, "launches": launches, "err": err,
           "instances": int(ops[0].shape[0]),
           "R": int(ops[0].shape[1]), "L": int(ops[2].shape[1]),
           **kernel_times(lambda: rowmax(*ops),
                          lambda: plain["dp_row_maxima"](*ops), 20),
           "cells": int((read_lens * (ref_lens + 1)).sum()),
           "census": census_rowmax(ref_lens, read_lens, int(ops[0].shape[1]),
                                   int(ops[2].shape[1]))["instructions"],
           "bytes": sum(t.numel() * t.element_size() for t in ops)
           + 4 * want.numel(), "tie": []}
    for ops in seen["tie"]:
        got = tie(*ops)
        want = plain["dp_tie_columns"](*ops)
        cpu = plain["dp_tie_columns"](*(t.cpu() for t in ops))
        check(all(torch.equal(g.cpu(), c) and torch.equal(w.cpu(), c)
                  for g, w, c in zip(got, want, cpu)),
              "tie columns on the card differ from the plain version or "
              "from CPU tensors")
        check(bool(cpu[1].any()), "dp_tie_columns: no tie column set")
        refs, ref_lens, reads, _read_lens, sel = (t.cpu().numpy()
                                                  for t in ops)
        L = reads.shape[1]
        rows = np.where((sel >= 1) & (sel <= L), sel, 0).max(axis=1)
        rec["tie"].append({
            "winners": int(refs.shape[0]), "rows": int(sel.shape[1]),
            "err": 0, **kernel_times(lambda: tie(*ops),
                                     lambda: plain["dp_tie_columns"](*ops),
                                     20),
            "cells": int((rows.astype(np.int64) * (ref_lens + 1)).sum()),
            "bytes": sum(t.numel() * t.element_size() for t in ops)
            + sum(4 * w.numel() for w in want)})
    rec["tie_variants"] = tie_variant_times(tie, plain["dp_tie_columns"],
                                            seen["tie"][0])
    print(json.dumps(rec), flush=True)
    return 0


def tie_variant_times(tie, plain, ops):
    """The tie kernel on operands made from the route's one call of both
    sides (``utils.time_rowmax.tie_variants``), each == plain on the card:
    its kernel alone (CUDA graph) and wrapper call, by variant."""
    from defuse_tpu_torch.utils.time_rowmax import tie_variants
    call = [t.cpu().numpy() for t in ops]
    half = call[0].shape[0] // 2
    sides = [[a[:half] for a in call], [a[half:] for a in call]]
    out = {}
    for name, arrays in tie_variants(sides).items():
        ts = [torch.from_numpy(np.ascontiguousarray(a)).to(ops[0].device)
              for a in arrays]
        check(all(torch.equal(g, w) for g, w in zip(tie(*ts), plain(*ts))),
              f"tie kernel differs from plain on the route's {name}")
        out[name] = {"instances": int(ts[0].shape[0]),
                     "ms": time_ms(lambda: tie(*ts), 20, graph=True),
                     "call_ms": time_ms(lambda: tie(*ts), 20)}
    return out


def no_native_device_em(card, cut, device, recs):
    """The second child's run (the batched EM on ``device``) against the
    native route and the oracle child, and what its metrics say."""
    out = cut / NO_NATIVE_OUT["device"]
    for name in ARTIFACTS:
        got = (out / name).read_bytes()
        check(got == (cut / "native" / name).read_bytes(),
              f"no-native, device EM: {name} differs from the native route")
        check(got == (cut / NO_NATIVE_OUT["oracle"] / name).read_bytes(),
              f"no-native, device EM: {name} differs from the oracle child")
    stage_s = {}
    for em_mode, sub in NO_NATIVE_OUT.items():
        metrics = json.loads((cut / sub / "metrics.discover.json")
                             .read_text())
        stage_s[em_mode] = {s["stage"].removeprefix("discover:"):
                            s["seconds"] for s in metrics["stages"]}
    counters = metrics["counters"]  # the device child's
    check(counters.get("em_impl") == IMPL[device],
          f"no-native, device EM: em_impl is {counters.get('em_impl')!r}")
    check(counters["em_select"]["n_instances"] > 0
          and counters["em_run"]["rows"] > 0,
          "no-native, device EM: the batched EM ran on nothing")
    check(recs["device"]["launches"]["split_dp_rowmax"] >= 1,
          "no-native, device EM: rowmax kernel never launched")
    check(device != "cuda" or (recs["device"]["launches"]["em_rows_kernel"]
                               > 0 and recs["device"]["plain_em_on_card"]
                               == 0),
          f"no-native, device EM: {recs['device']['launches']}, plain EM "
          f"on the card {recs['device']['plain_em_on_card']} times")
    say(card, f"no-native discover with em_mode=device "
              f"(em_impl {counters['em_impl']}): "
              f"{recs['device']['seconds']:.3f} s against "
              f"{recs['oracle']['seconds']:.3f} s with the Python EM; "
              f"cluster stage {stage_s['device']['cluster']} s against "
              f"{stage_s['oracle']['cluster']} s; "
              f"{counters['em_select']['n_instances']} instances, "
              f"n_host_resolved "
              f"{counters['em_select']['n_host_resolved']}; "
              f"{len(ARTIFACTS)} artifacts byte-identical to the oracle "
              f"child's and the native route's; em_rows_kernel launches "
              f"{recs['device']['launches']['em_rows_kernel']}, the plain "
              f"EM on the card {recs['device']['plain_em_on_card']} times; "
              f"EM run stats {counters['em_run']}")
    recs["device"].update(cluster_s=stage_s["device"]["cluster"],
                          oracle_cluster_s=stage_s["oracle"]["cluster"],
                          em_select=counters["em_select"],
                          em_run=counters["em_run"])


def phase_no_native(card, work, device):
    from defuse_tpu_torch.pipeline.discover import discover_fusions
    from defuse_tpu_torch.utils import synth
    cut = work / "cut"
    _ds, paths, n_pairs = synth.build_dataset(cut, NO_NATIVE_FUSIONS,
                                              NO_NATIVE_BACKGROUND)
    # the child parses the fastqs in Python: hand both routes the files as
    # written, not the native ingest's renamed copies
    paths["fastq1"], paths["fastq2"] = raw_fastqs(cut)
    t0 = time.time()
    discover_fusions(outdir=str(cut / "native"), device=device,
                     **discover_kwargs(paths))
    t_native = time.time() - t0
    recs = {}
    for em_mode in NO_NATIVE_OUT:
        proc = subprocess.run(
            [sys.executable, str(REPO / "chip_smoke.py"),
             "--no-native-child", str(cut), device, em_mode],
            env=dict(os.environ, DEFUSE_NO_NATIVE="1"),
            capture_output=True, text=True, timeout=600, cwd=REPO)
        check(proc.returncode == 0,
              f"no-native child ({em_mode}) failed: {proc.stderr[-3000:]}")
        recs[em_mode] = json.loads(proc.stdout.strip().splitlines()[-1])
    rec = recs["oracle"]
    for name in ARTIFACTS:
        check((cut / "native" / name).read_bytes() ==
              (cut / "no_native" / name).read_bytes(),
              f"no-native: {name} differs from the native route")
    check(len((cut / "no_native" / "splitreads.seq").read_bytes()) > 0,
          "no-native: no fusion sequences produced")
    counters = json.loads((cut / "no_native" / "metrics.discover.json")
                          .read_text())
    check(counters["counters"].get("split_dp_impl") == IMPL[device],
          "no-native: split_dp_impl")
    check(rec["launches"]["split_dp_rowmax"] == 1
          and rec["launches"]["split_dp_tie_columns"] == 1,
          f"no-native: launches {rec['launches']}")
    check(rec["err"] == 0, "rowmax kernel differs from plain on the "
                           "route's operands")
    stages = " ".join(f"{s['stage'].removeprefix('discover:')}="
                      f"{s['seconds']}" for s in counters["stages"])
    say(card, f"discover without the native library on {n_pairs} pairs "
              f"({NO_NATIVE_FUSIONS} fusions): {rec['seconds']:.3f} s, "
              f"native route {t_native:.3f} s; {len(ARTIFACTS)} artifacts "
              f"byte-identical; launches {rec['launches']}")
    say(card, f"no-native stages (s): {stages}")
    say(card, f"rowmax_kernel on the route's operands ({rec['instances']} "
              f"instances, R={rec['R']}, L={rec['L']}): kernel "
              f"{rec['ms']:.4f} ms, wrapper call "
              f"{rec['call_ms']:.4f} ms (PRs 5-8: 0.0469-0.0657 ms a call), "
              f"plain {rec['plain_ms']:.3f} ms, max_abs_err {rec['err']}")
    say(card, "tie columns on the route's operands (== plain and == CPU "
              "tensors bit for bit): " + "; ".join(
                  f"{t['winners']} winners x {t['rows']} rows: kernel "
                  f"{t['ms']:.4f} ms, wrapper call {t['call_ms']:.4f} ms, "
                  f"plain {t['plain_ms']:.3f} ms" for t in rec["tie"])
              + " (the plain version on the card, PRs 5-8: 8.4-13.9 ms)")
    v = rec["tie_variants"]
    say(card, "tie kernel on operands made from the route's (== plain; "
              "kernel alone | wrapper call, ms): " + "; ".join(
                  f"{name} ({t['instances']}) {t['ms']:.4f} | "
                  f"{t['call_ms']:.4f}" for name, t in v.items())
              + f"; a warp's row chain (lone pair less the floor) "
              f"{v['lone_pair']['ms'] - v['floor']['ms']:.4f} ms")
    no_native_device_em(card, cut, device, recs)
    rec["device_em"] = recs["device"]
    return rec


# --- phase 11 ---------------------------------------------------------------

def phase_cohort(card, work, dataset, device):
    from defuse_tpu_torch.cli.main import main as cli
    from defuse_tpu_torch.utils import synth
    _ds, _paths, n_pairs = dataset
    libs = ("libA", "libB")
    for end, src in zip("12", raw_fastqs(work)):
        synth.deal_fastq(src, [work / f"{lib}.{end}.fastq" for lib in libs])
    manifest = work / "cohort.tsv"
    manifest.write_text("".join(
        f"{lib}\t{work}/{lib}.1.fastq\t{work}/{lib}.2.fastq\n"
        for lib in libs))
    env_path = os.environ.get("PYTHONPATH")
    os.environ["PYTHONPATH"] = str(REPO) + (os.pathsep + env_path
                                            if env_path else "")
    try:
        t0 = time.time()
        check(cli(["cohort", "-c", str(work / "run_refs" / "config.txt"),
                   "-d", str(work / "run_dataset"), "-m", str(manifest),
                   "-o", str(work / "cohort"), "-w", "2", "--device",
                   device]) == 0, "cohort")
        seconds = time.time() - t0
    finally:
        if env_path is None:
            del os.environ["PYTHONPATH"]
        else:
            os.environ["PYTHONPATH"] = env_path
    summary = [ln.split("\t") for ln in (work / "cohort" /
               "cohort_summary.tsv").read_text().splitlines()[1:]]
    check([r[:2] for r in summary] == [[lib, "ok"] for lib in libs],
          f"cohort summary: {summary}; " + " | ".join(
              (work / "cohort" / lib / "cohort.log").read_text()[-1500:]
              for lib in libs))
    fusions = (work / "cohort" / "cohort_fusions.tsv").read_text() \
        .splitlines()
    check(len(fusions) > 1, "cohort_fusions.tsv is empty")
    routes = {}
    for lib in libs:
        counters = json.loads((work / "cohort" / lib /
                               "metrics.discover.json").read_text())
        routes[lib] = counters["counters"].get("screen_route")
        impl = counters["counters"].get("split_dp_impl")
        check(routes[lib] is not None and impl == (
            IMPL[device] if routes[lib]["choice"] == "device" else None),
              f"cohort {lib}: split_dp_impl {impl!r}, screen_route "
              f"{routes[lib]}")
    recurrent = len((work / "cohort" / "cohort_recurrent.tsv").read_text()
                    .splitlines()) - 1
    say(card, f"cohort of {len(libs)} libraries ({n_pairs // 2} pairs each, "
              f"2 workers sharing the card): {seconds:.3f} s; both ok "
              f"(n_fusions {[r[2] for r in summary]}, seconds "
              f"{[r[3] for r in summary]}); {len(fusions) - 1} pooled "
              f"fusions, {recurrent} gene pairs in cohort_recurrent.tsv; "
              f"screen routes {routes}")


# --- phase 12 ---------------------------------------------------------------

EM_DTYPES = {"float64": torch.float64, "float32": torch.float32}


def same_bits(a, b):
    """Two float arrays hold the same bits (a NaN equals itself)."""
    return a.dtype == b.dtype and a.tobytes() == b.tobytes()


def em_operands(batch, dtype, dev):
    """``em_run``'s operands of the whole batch at its padded width."""
    return [torch.as_tensor(v, dtype=dtype, device=dev)
            for v in (batch.x, batch.y, batch.u)] + \
        [torch.as_tensor(batch.n, device=dev),
         torch.as_tensor(batch.k, device=dev),
         torch.as_tensor(batch.r0, dtype=dtype, device=dev)]


def em_profiled(fn):
    """One ``torch.profiler`` pass over ``fn()``: the device time of its
    ``em_rows_kernel`` launches (ms) and their count, all its kernel
    launches, the device's busy share from its first kernel to its last,
    and its wall (ms, to the last synchronise).  Device figures are None
    where the profiler records no device event."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall = (time.perf_counter() - t0) * 1e3
    spans = [(e.name, e.time_range.start, e.time_range.end)
             for e in prof.events() if e.device_type == DeviceType.CUDA]
    kernel = [(s, e) for name, s, e in spans if "em_rows_kernel" in name]
    if not spans:
        return {"kernel_ms": None, "kernel_launches": None,
                "launches": None, "busy": None, "wall_ms": wall}
    first = min(s for _n, s, _e in spans)
    last = max(e for _n, _s, e in spans)
    return {"kernel_ms": sum(e - s for s, e in kernel) / 1e3,
            "kernel_launches": len(kernel), "launches": len(spans),
            "busy": sum(e - s for _n, s, e in spans) / (last - first),
            "wall_ms": wall}


# the EM's operations a live row-iteration, as the bound counts them (each
# add, multiply, divide, compare, exp and log one fp64 operation): an
# exponent term (point x component: the exponent's 15, its max, the weighted
# density's subtract, exp and multiply, the sum, the responsibility's
# divide), a term of the M-step's two sums (x + y + u, the product and two
# adds), and a step of the merge (x + y, the product, the difference, the
# divide, lam x sum, the add, the compare, the running sum)
EM_OPS_TERM, EM_OPS_SUMS, EM_OPS_STEP = 21, 5, 8
FP64_OPS_S = 34e12  # H100 SXM, fp64 outside the tensor cores (data sheet)


def em_bound(batch, it_done, itemsize):
    """(bytes, least ops, ops with every merge walked to its end) of the
    whole batch run to its end: each operand read once and each output
    written once; per live row-iteration k*n exponent terms and sum terms
    and one merge step a component (how far a merge walks depends on the
    data and is not measured: at most 2n steps)."""
    B, KM, N = batch.r0.shape
    live = np.minimum(it_done, 300).astype(np.float64)
    kn = live * batch.k * batch.n
    least = float((kn * (EM_OPS_TERM + EM_OPS_SUMS)
                   + live * batch.k * EM_OPS_STEP).sum())
    most = least + float((kn * 2 * EM_OPS_STEP).sum())
    work = (3 * B * N + 2 * B * KM * N + 5 * B * KM + 2 * B) * itemsize \
        + B * (4 + 4 + 1 + 1 + 4)
    return work, least, most


def em_edge_batches(em, params, seed=11):
    """The M-step's edge cases (``tests/test_torch_em_kernel.py`` has the
    same kinds): name -> (batch, responsibilities, a, b)."""
    import dataclasses

    from defuse_tpu_torch.utils.synth import em_instance
    rng = np.random.default_rng(seed)
    base = [em_instance(rng, rng.integers(1, 4), 24) for _ in range(4)]
    grid = [(np.round(x / 20) * 20, np.round(y / 20) * 20, u)
            for x, y, u in base]
    sets = {"random": base, "massless": base, "n1_n2": base,
            "x_runs": [(gx, y, u) for (gx, _g, u), (_x, y, _u)
                       in zip(grid, base)],
            "y_runs": [(x, gy, u) for (_g, gy, u), (x, _y, _u)
                       in zip(grid, base)],
            "both_runs": grid, "zero_in_runs": grid,
            "equal_sums": [(x, x + 500.0, u) for x, _y, u in base],
            "no_rising": [(x, y, u - 4000.0) for x, y, u in base],
            "first_rising": [(x, y, u + 4000.0) for x, y, u in base],
            "wide": [em_instance(rng, 2, 100), em_instance(rng, 3, 150),
                     em_instance(rng, 1, 70)]}
    out = {}
    for name, instances in sets.items():
        batch = em.prepare_batch(instances, params)
        B, KM, N = batch.r0.shape
        if name == "n1_n2":  # each row cut to its first point or two
            batch = dataclasses.replace(
                batch, n=(1 + np.arange(B) % 2).astype(batch.n.dtype))
        r = rng.random((B, KM, N)) * \
            (np.arange(KM)[None, :, None] < batch.k[:, None, None])
        if name == "zero_in_runs":  # whole points without mass
            r = r * (rng.random((B, 1, N)) < 0.5)
        if name == "massless":  # the first component at K >= 2
            r[batch.k >= 2, 0] = 0.0
        r = r / np.maximum(r.sum(axis=1, keepdims=True), 1e-300)
        out[name] = (batch, r, rng.normal(1e5, 1e4, (B, KM)),
                     rng.normal(1e5, 1e4, (B, KM)))
    return out


def em_m_step_forms(card, batch, params, dev):
    """The kernel's two M-steps on the card (``em_cuda.m_step_check``: the
    sequential walk and the warp form ``em_rows_kernel`` runs) on the same
    responsibilities: the bench batch's after 1, 5 and 20 iterations of the
    kernel, and the edge cases, in float64 and float32.  Any differing bit
    of a, b or nk fails the phase, its rows printed."""
    from defuse_tpu_torch.cluster import matepair_em_batch as em
    from defuse_tpu_torch.ops import em_cuda
    sigma = params.fragment_stddev
    cases = []
    for name, dtype in EM_DTYPES.items():
        x, y, u, n, k, r0 = em_operands(batch, dtype, dev)
        B, KM, _N = r0.shape
        r0 = torch.where(torch.arange(KM, device=dev)[None, :, None]
                         < k[:, None, None], r0, 0.0)
        for iters in (1, 5, 20):
            r = r0.clone()
            a = torch.zeros((B, KM), dtype=dtype, device=dev)
            b = torch.zeros_like(a)
            ll = torch.full((B,), -float(em.BIG), dtype=dtype, device=dev)
            em_cuda.em_rows(x, y, u, n, k, r, a, b, ll, max_iters=iters,
                            never=em.MAX_ITERS + 1, sigma=sigma,
                            lam=em.LAMBDA, tol=em.TOLERANCE)
            cases.append((f"bench batch after {iters} iterations", name,
                          (x, y, u, n, k, r, a, b)))
        for edge, (eb, er, ea, ebb) in em_edge_batches(em, params).items():
            cases.append((f"edge case {edge}", name, [
                torch.as_tensor(v, dtype=dtype, device=dev)
                for v in (eb.x, eb.y, eb.u)] + [
                torch.as_tensor(v, dtype=torch.int32, device=dev)
                for v in (eb.n, eb.k)] + [
                torch.as_tensor(v, dtype=dtype, device=dev).contiguous()
                for v in (er, ea, ebb)]))
    components = 0
    for label, name, ops in cases:
        got = em_cuda.m_step_check(*ops, sigma=sigma, lam=em.LAMBDA)
        walk, warp = ([v.cpu().numpy() for v in got[form]]
                      for form in ("walk", "warp"))
        components += int((walk[2] > 0).sum())
        for what, p, q in zip(("a", "b", "nk"), walk, warp):
            differ = (p.view(np.uint8).reshape(len(p), -1)
                      != q.view(np.uint8).reshape(len(q), -1)).any(axis=1)
            check(not differ.any(),
                  f"EM M-step, {label} ({name}): the warp form's {what} "
                  f"differs from the walk's in rows "
                  f"{np.nonzero(differ)[0][:8].tolist()}: "
                  f"{q[differ][:2].tolist()} against "
                  f"{p[differ][:2].tolist()}")
    say(card, f"EM M-step on the card, the warp form (em_rows_kernel's) "
              f"against the walk: {len(cases)} cases (the bench batch "
              f"after 1, 5 and 20 iterations and "
              f"{len(cases) // len(EM_DTYPES) - 3} edge cases, float64 and "
              f"float32), {components} components with mass: a, b and nk "
              f"the same bits")
    return {"cases": len(cases), "components": components}


def phase_em(card, dataset, dev):
    from unittest import mock

    from defuse_tpu_torch.cluster import matepair_em_batch as em
    from defuse_tpu_torch.cluster import native
    from defuse_tpu_torch.cluster.discordant import collect_bin_pair_tasks
    from defuse_tpu_torch.cluster.matepair_em import EMParams
    from defuse_tpu_torch.io.sam import iter_compact, load_alignments
    from defuse_tpu_torch.ops import em_cuda
    from defuse_tpu_torch.utils import synth

    _ds, paths, _n_pairs = dataset
    params = EMParams(synth.MEAN, synth.STD, synth.PREC, synth.MINCL)
    sigma = params.fragment_stddev
    tasks = collect_bin_pair_tasks(
        load_alignments(iter_compact(str(paths["spanning"]))), params)
    instances = [(t.x, t.y, t.u) for t in tasks]
    t0 = time.time()
    want = [[sorted(c) for c in clusters]
            for clusters in native.em_cluster_batch(instances, params)]
    t_native = time.time() - t0
    t0 = time.time()
    batch = em.prepare_batch(instances, params)
    t_prepare = time.time() - t0
    check(sum(map(len, want)) > 0, "EM: the native EM found no cluster")

    def held(got, label):
        """No tolerance and no second try: the first instance whose
        memberships differ from the native answer fails the phase."""
        for i, exp in enumerate(want):
            mine = [sorted(c) for c in got.get(i, [])]
            check(mine == exp, f"EM {label}: instance {i} (n "
                               f"{len(instances[i][0])}) has {mine}, the "
                               f"native EM {exp}")

    def plain():
        """``em_run`` as the plain loop, for the comparison runs only."""
        return mock.patch.object(em, "_build_em_run",
                                 em._build_em_run_plain)

    rec = {"instances": len(instances), "rows": int(len(batch.n)),
           "max_n": int(batch.n.max()), "native_s": t_native,
           "prepare_s": t_prepare}
    say(card, f"EM on the bench dataset's bin pairs: {rec['instances']} "
              f"instances, {rec['rows']} (instance, K) rows, widest N "
              f"{rec['max_n']}; native EM {t_native:.3f} s, prepare_batch "
              f"{t_prepare:.3f} s")
    # the main path's call: run_batch on the card, its launches counted
    em_cuda.reset_launches()
    plain_before = em.PLAIN_RUNS["cuda"]
    t0 = time.time()
    got64 = em.run_batch(batch, params, device=dev)
    rec["run_batch_s"] = time.time() - t0
    rec["launches"] = em_cuda.LAUNCHES["em_rows_kernel"]
    rec["run_batch_stats"] = dict(em.EM_RUN_STATS)
    check(rec["launches"] == em.EM_RUN_STATS["slabs"] > 0
          and em.PLAIN_RUNS["cuda"] == plain_before,
          f"EM: {rec['launches']} em_rows_kernel launches for "
          f"{em.EM_RUN_STATS['slabs']} slab segments, the plain loop "
          f"{em.PLAIN_RUNS['cuda'] - plain_before} times on the card")
    held(got64, "float64 on the card")
    for name, dtype in EM_DTYPES.items():
        runs = []
        for _ in range(2):
            torch.cuda.reset_peak_memory_stats(dev)
            t0 = time.time()
            outs = em.run_em(batch, params, dtype, dev)
            torch.cuda.synchronize()
            runs.append((time.time() - t0, outs, dict(em.EM_RUN_STATS),
                         torch.cuda.max_memory_allocated(dev)))
        for x, y, what in zip(runs[0][1], runs[1][1], ("a", "b", "ll", "ok")):
            check(same_bits(x, y), f"EM {name}: two runs differ in {what}")
        # one launch at the padded width, and the whole run in one segment
        t0 = time.time()
        whole = em.run_em(batch, params, dtype, dev, chunk_rows=0)
        whole_s = time.time() - t0
        with mock.patch.object(em, "SEGMENT_ITERS", em.MAX_ITERS):
            t0 = time.time()
            one_segment = em.run_em(batch, params, dtype, dev)
            one_segment_s = time.time() - t0
            one_segment_stats = dict(em.EM_RUN_STATS)
        for label, other in (("one launch", whole),
                             ("one segment", one_segment)):
            for x, y, what in zip(runs[0][1], other, ("a", "b", "ll", "ok")):
                check(same_bits(x, y), f"EM {name}: {label} differs from "
                                       f"the bucketed run in {what}")
        t0 = time.time()
        got = em.run_batch(batch, params, dtype=dtype, device=dev)
        t_batch = time.time() - t0
        select = dict(em.LAST_SELECT_STATS)
        held(got, f"{name} on the card")
        check(select["exact_resolve"] == (name == "float32"),
              f"EM {name}: exact_resolve is {select['exact_resolve']}")
        stats = runs[1][2]
        slab_bytes = stats["slab_elems_max"] * torch.empty(
            0, dtype=dtype).element_size()
        rec[name] = {
            "first_s": runs[0][0], "device_s": runs[1][0],
            "one_launch_s": whole_s, "one_segment_s": one_segment_s,
            "one_segment_stats": one_segment_stats,
            "select_s": t_batch - em.EM_RUN_STATS["wall_s"],
            "n_host_resolved": select["n_host_resolved"],
            "peak_bytes": runs[1][3],
            "peak_over_largest_slab": runs[1][3] / slab_bytes,
            "stats": stats}
        say(card, f"EM {name} on the card: run_em {runs[1][0]:.4f} s "
                  f"(first run {runs[0][0]:.4f} s), one launch at the "
                  f"padded width {whole_s:.4f} s, one segment "
                  f"{one_segment_s:.4f} s ({one_segment_stats['slabs']} "
                  f"launches); all three the same bits; select "
                  f"{rec[name]['select_s']:.3f} s, n_host_resolved "
                  f"{select['n_host_resolved']} of {select['n_instances']}; "
                  f"memberships == native on all {len(want)} instances; two "
                  f"runs equal bit for bit; {stats['groups']} groups, "
                  f"{stats['slabs']} slabs x segments, {stats['segments']} "
                  f"segments, {stats['iters']} iterations, row-iterations "
                  f"{stats['row_iters_run']} run / {stats['row_iters_live']} "
                  f"live; peak device memory {runs[1][3] / 1e6:.1f} MB; run "
                  f"stats {stats}")

    # the kernel against the plain loop on the card, float64, the whole
    # batch in one call at its padded width
    ops = em_operands(batch, torch.float64, dev)
    kernel_out = em.make_em_step(sigma)(*ops)
    torch.cuda.synchronize()
    t0 = time.time()
    plain_out = em._build_em_run_plain(sigma)(*ops)
    torch.cuda.synchronize()
    rec["plain_call_s"] = time.time() - t0
    k_out, p_out = ([v.cpu().numpy() if torch.is_tensor(v) else v
                     for v in out] for out in (kernel_out, plain_out))
    same = (k_out[9] == p_out[9]) & (k_out[4] == p_out[4])
    active = (np.arange(batch.r0.shape[1])[None, :] < batch.k[:, None]) \
        & same[:, None]
    d_ab = np.maximum(np.abs(k_out[0] - p_out[0]),
                      np.abs(k_out[1] - p_out[1]))
    d_ll = np.abs(k_out[3] - p_out[3]) / np.maximum(1.0, np.abs(p_out[3]))
    rec["vs_plain"] = {
        "max_abs_ab": float(d_ab[active].max()),
        "max_rel_ll": float(d_ll[same].max()),
        "rows_it_done_differ": int((k_out[9] != p_out[9]).sum()),
        "rows_ok_differ": int((k_out[4] != p_out[4]).sum()),
        "iters": [int(k_out[5]), int(p_out[5])]}
    worst = int(np.argmax(np.where(active, d_ab, -1).max(axis=1)))
    check(rec["vs_plain"]["max_abs_ab"] <= 1e-4
          and rec["vs_plain"]["max_rel_ll"] <= 1e-9,
          f"EM kernel against the plain loop: {rec['vs_plain']}; worst row "
          f"{worst} (instance {batch.instance[worst]}, n {batch.n[worst]}, "
          f"k {batch.k[worst]}): a {k_out[0][worst]} against "
          f"{p_out[0][worst]}, b {k_out[1][worst]} against "
          f"{p_out[1][worst]}, ll {k_out[3][worst]} against "
          f"{p_out[3][worst]}")
    # float32: only the decisions, ok on the rows that finished at the
    # same iteration
    ops32 = em_operands(batch, torch.float32, dev)
    k32, p32 = ([v.cpu().numpy() if torch.is_tensor(v) else v
                 for v in run(*ops32)]
                for run in (em.make_em_step(sigma),
                            em._build_em_run_plain(sigma)))
    same32 = k32[9] == p32[9]
    rec["vs_plain_float32"] = {
        "rows_it_done_differ": int((~same32).sum()),
        "rows_ok_differ_same_it": int((k32[4] != p32[4])[same32].sum()),
        "rows_ok_differ": int((k32[4] != p32[4]).sum())}
    check(rec["vs_plain_float32"]["rows_ok_differ_same_it"] == 0,
          f"EM float32: ok differs from the plain loop on rows that "
          f"finished at the same iteration: {rec['vs_plain_float32']}")
    with plain():
        t0 = time.time()
        plain_batch = em.run_batch(batch, params, device=dev)
        rec["plain_run_batch_s"] = time.time() - t0
        rec["plain_stats"] = dict(em.EM_RUN_STATS)
    held(plain_batch, "the plain loop, float64 on the card")
    check(plain_batch == got64, "EM: the kernel's memberships differ from "
                                "the plain loop's")
    t0 = time.time()
    held(em.run_batch(batch, params, device="cpu"), "float64 on CPU tensors")
    rec["cpu_s"] = time.time() - t0
    say(card, f"EM float64 on CPU tensors (the plain loop): "
              f"{rec['cpu_s']:.3f} s, memberships == native")
    say(card, f"EM kernel against the plain loop on the card (float64, "
              f"{rec['rows']} rows in one call): memberships equal (and "
              f"== native); on rows with the same ok and it_done, max |a, b| "
              f"difference {rec['vs_plain']['max_abs_ab']:.3e} bases, max "
              f"relative ll difference {rec['vs_plain']['max_rel_ll']:.3e}; "
              f"rows whose it_done differs "
              f"{rec['vs_plain']['rows_it_done_differ']}, whose ok differs "
              f"{rec['vs_plain']['rows_ok_differ']}; iterations "
              f"{rec['vs_plain']['iters']} (kernel, plain); float32 "
              f"{rec['vs_plain_float32']}")

    rec["m_step_forms"] = em_m_step_forms(card, batch, params, dev)

    # timings: the kernel alone (its device time in one profiled call of
    # the whole batch, and in a profiled run_em), the calls' walls
    em.make_em_step(sigma)(*ops)
    one = em_profiled(lambda: em.make_em_step(sigma)(*ops))
    bucketed = em_profiled(lambda: em.run_em(batch, params, torch.float64,
                                             dev))
    work, least, most = em_bound(batch, k_out[9], 8)
    bound_ms, bound_by = bound(work, least / FP64_OPS_S * 1e3)
    call_ms = time_ms(lambda: em.make_em_step(sigma)(*ops), 3)
    rec.update(kernel_ms=one["kernel_ms"] or call_ms, call_ms=call_ms,
               launches_per_call=one["launches"], busy_share=one["busy"],
               run_em_profile=bucketed, plain_ms=rec["plain_call_s"] * 1e3,
               bound_ms=bound_ms, bound_by=bound_by, bytes=work,
               ops_least=least, ops_most=most,
               bound_most_ms=bound(work, most / FP64_OPS_S * 1e3)[0],
               max_abs_err=rec["vs_plain"]["max_abs_ab"])
    # a batch-iteration with every row held running (tol below 0), and
    # where a row-iteration's time goes (utils/time_em's phase clock)
    from defuse_tpu_torch.utils.time_em import phase_cycles

    B, KM = ops[5].shape[:2]
    r_held = torch.where(torch.arange(KM, device=dev)[None, :, None]
                         < ops[4][:, None, None], ops[5], 0.0)

    def held(iters):
        r = r_held.clone()
        a = torch.zeros((B, KM), dtype=torch.float64, device=dev)
        b = torch.zeros_like(a)
        ll = torch.full((B,), -float(em.BIG), dtype=torch.float64,
                        device=dev)
        em_cuda.em_rows(*ops[:5], r, a, b, ll, max_iters=iters,
                        never=em.MAX_ITERS + 1, sigma=sigma, lam=em.LAMBDA,
                        tol=-1.0)
    held_ms = {m: time_ms(lambda m=m: held(m), 3) for m in (10, 30)}
    rec["ms_per_batch_iteration"] = (held_ms[30] - held_ms[10]) / 20
    rec["phases"] = phase_cycles(REPO, batch, params)
    say(card, f"EM kernel's split, float64: a batch-iteration with all "
              f"{rec['rows']} rows held running "
              f"{rec['ms_per_batch_iteration']:.4f} ms (held 10 and 30 "
              f"iterations: {held_ms[10]:.3f}, {held_ms[30]:.3f} ms); SM "
              f"cycles a row-iteration (phase clock, "
              f"{rec['phases']['row_iterations']} row-iterations): " +
        ", ".join(f"{k} {v:.0f}" for k, v in rec["phases"]["cycles"].items())
        + f"; the M-step's share {100 * rec['phases']['m_step_share']:.1f}%")
    say(card, "EM timings, float64: " + (
        "torch.profiler recorded no device event (kernel time not "
        "measured)" if one["kernel_ms"] is None else
        f"em_rows_kernel alone {one['kernel_ms']:.3f} ms for the whole "
        f"batch in one launch ({one['launches']} device launches a call, "
        f"busy {100 * one['busy']:.1f}%), the call {call_ms:.3f} ms "
        f"(CUDA events); in run_em {bucketed['kernel_ms']:.3f} ms of kernel over "
        f"{bucketed['kernel_launches']} launches in a wall of "
        f"{bucketed['wall_ms']:.3f} ms (busy "
        f"{100 * bucketed['busy']:.1f}%)") +
        f"; the plain loop {rec['plain_call_s']:.3f} s a call, run_batch "
        f"{rec['plain_run_batch_s']:.3f} s; native EM {t_native:.3f} s; "
        f"bound {bound_ms:.4f} ms by {bound_by} ({work / 1e6:.2f} MB, "
        f"{least:.3e} operations with one merge step a component; "
        f"{rec['bound_most_ms']:.4f} ms with every merge walked to 2n "
        f"steps)")
    return rec


# --- phase 13 ---------------------------------------------------------------

DIST_LIMIT_S = 300  # each rank's limit, and its gloo group's on a collective
DIST_ARTIFACTS = ("results.tsv", "results.classify.tsv",
                  "results.filtered.tsv", "clusters", "splitreads.break")


def phase_entry(card, dev):
    """``entry()`` on the card: ``rowmax_kernel`` launched, the outputs
    equal to ``entry(device="cpu")`` bit for bit; then the forward step
    timed with the kernel and with the plain version on the card."""
    from defuse_tpu_torch.entry import entry
    from defuse_tpu_torch.ops import split_dp_batch, split_dp_cuda
    fn, args = entry("cuda")
    split_dp_cuda.reset_launches()
    got = fn(*args)
    torch.cuda.synchronize()
    launches = split_dp_cuda.LAUNCHES["split_dp_rowmax"]
    cpu_fn, cpu_args = entry("cpu")
    want = cpu_fn(*cpu_args)
    for g, w, name in zip(got, want, ("max_score", "best_k")):
        check(g.dtype == w.dtype and torch.equal(g.cpu(), w),
              f"entry: {name} on the card differs from the CPU")
    check(launches == 2, f"entry: rowmax_kernel launched {launches} times")
    check(int((want[0] > 0).sum()) > 0, "entry: no split accepted")
    r1p, r1l, rp, rl, r2p, r2l, rrp, mins = args

    def plain():
        return split_dp_batch.combine_split_scores(
            split_dp_batch.dp_row_maxima(r1p, r1l, rp, rl),
            split_dp_batch.dp_row_maxima(r2p, r2l, rrp, rl), rl, mins)

    rec = {"launches": launches, "ms": time_ms(lambda: fn(*args), 20),
           "plain_ms": time_ms(plain, 5)}
    say(card, f"entry() on {dev}: (max_score, best_k) == entry(device="
              f"'cpu') bit for bit, {int((want[0] > 0).sum())} of 64 "
              f"accepted; rowmax_kernel launches {launches}; forward "
              f"{rec['ms']:.4f} ms, with the plain version on the card "
              f"{rec['plain_ms']:.3f} ms")
    return rec


def dist_run_child(work):
    """Phase 13's rank (``--dist-run-child``, ``RANK``/``WORLD_SIZE``/
    ``MASTER_*`` in its environment): the frontend over its shard with the
    shard's global fragment-id base, the read-stats sums gathered, then
    rank 0 ``run_pipeline(dist=ctx)`` on the card while the others run
    ``tail_partition_worker``.  Prints one JSON line."""
    import torch.distributed as dist
    from defuse_tpu_torch.align import frontend
    from defuse_tpu_torch.cluster import native
    from defuse_tpu_torch.config import Config
    from defuse_tpu_torch.ops import split_dp_cuda
    from defuse_tpu_torch.parallel.launch import (
        DistContext, allgather_read_stats_sums, init_distributed,
        merge_artifacts, rank_device, tail_partition_worker)
    from defuse_tpu_torch.pipeline.run import run_pipeline
    meta = json.loads((work / "meta.json").read_text())
    pid, n = init_distributed(timeout=DIST_LIMIT_S)
    dev = rank_device(meta["device"])
    ctx = DistContext(pid, n)
    config = Config.read(meta["config"], meta["dataset"])
    split_dp_cuda.reset_launches()
    t0 = time.time()
    prefix = meta["shard_prefixes"][pid]
    with StageClock() as clock:
        aligned = frontend.align_reads(config, str(work / f"rank{pid}"),
                                       f"{prefix}.1.fastq",
                                       f"{prefix}.2.fastq",
                                       frag_base=pid * meta["per_shard"],
                                       device=dev)
        stats = allgather_read_stats_sums(
            *native.read_stats_tbl_sums(aligned["pair_table"]))
        ctx.barrier("frontend_done")
        if pid == 0:
            ranks = [work / f"rank{r}" for r in range(n)]
            merged = merge_artifacts([r / "aligned" for r in ranks],
                                     work / "merged")
            run_pipeline(
                config=config, output_dir=str(work / "out"),
                library_name="smoke", spanning=merged["spanning.compact"],
                improper=merged["improper.sam"], fastq1=meta["fastq1"],
                fastq2=meta["fastq2"], concordant_sam=None,
                read_stats=stats,
                pair_table=[str(r / "aligned" / "cdna.pair.tbl")
                            for r in ranks],
                reads_sources=[(str(r / "reads" / "reads.1.fastq"),
                                str(r / "reads" / "reads.2.fastq"),
                                i * meta["per_shard"])
                               for i, r in enumerate(ranks)],
                gene_models_gtf=config.get_value("gene_models"),
                genome_fasta=config.get_value("genome_fasta"),
                repeats_regions=config.get_value("repeats_regions"),
                use_device=True, device=dev, dist=ctx)
        else:
            tail_partition_worker(ctx, work / "out",
                                  pair_table=aligned["pair_table"])
    seconds = time.time() - t0
    launches = dict(split_dp_cuda.LAUNCHES)
    rec = {"rank": pid, "world_size": n, "backend": dist.get_backend(),
           "device": str(dev), "seconds": seconds, "launches": launches,
           "stages": clock.stages(work / "out") if pid == 0 else
           {k: round(v, 3) for k, v in clock.seconds.items()}}
    ctx.barrier("pipeline_done")
    check_no_reference_modules()
    dist.destroy_process_group()
    print(json.dumps(rec), flush=True)
    return 0


def dist_ranks(work, n):
    """Start ``n`` ranks of ``dist_run_child`` and wait for every one within
    DIST_LIMIT_S; a rank that fails or runs over fails the phase, the
    others killed.  Returns their JSON lines in rank order."""
    from defuse_tpu_torch.entry import _free_port
    port = _free_port()
    procs = [subprocess.Popen(
        [sys.executable, str(REPO / "chip_smoke.py"), "--dist-run-child",
         str(work)], cwd=REPO, text=True, stdout=subprocess.PIPE,
        stderr=subprocess.PIPE,
        env=dict(os.environ, RANK=str(r), WORLD_SIZE=str(n),
                 LOCAL_RANK=str(r), MASTER_ADDR="localhost",
                 MASTER_PORT=str(port))) for r in range(n)]
    recs = []
    try:
        for r, p in enumerate(procs):
            try:
                out, err = p.communicate(timeout=DIST_LIMIT_S)
            except subprocess.TimeoutExpired:
                check(False, f"dist run: rank {r} still running after "
                             f"{DIST_LIMIT_S} s")
            check(p.returncode == 0, f"dist run: rank {r} exited "
                                     f"{p.returncode}: {err[-3000:]}")
            recs.append(json.loads(out.strip().splitlines()[-1]))
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.communicate()
    return recs


def phase_dist_run(card, work, dataset, dev):
    """The phase-9 dataset through ``run`` on two processes sharing the
    card (gloo), against one process on the same inputs."""
    from defuse_tpu_torch.align.frontend import align_reads
    from defuse_tpu_torch.config import Config
    from defuse_tpu_torch.ops import split_dp_cuda
    from defuse_tpu_torch.parallel.shard import split_fastq
    from defuse_tpu_torch.pipeline.run import run_pipeline
    _ds, _paths, n_pairs = dataset
    meta = {"config": str(work / "run_refs" / "config.txt"),
            "dataset": str(work / "run_dataset"),
            "per_shard": -(-n_pairs // 2), "device": dev.type}
    config = Config.read(meta["config"], meta["dataset"])
    one = work / "dist_one"
    split_dp_cuda.reset_launches()
    t0 = time.time()
    aligned = align_reads(config, str(one), *raw_fastqs(work), device=dev)
    run_pipeline(config=config, output_dir=str(one), library_name="smoke",
                 gene_models_gtf=config.get_value("gene_models"),
                 genome_fasta=config.get_value("genome_fasta"),
                 repeats_regions=config.get_value("repeats_regions"),
                 use_device=True, device=dev, **aligned)
    t_one = time.time() - t0
    one_screens = split_dp_cuda.LAUNCHES["split_dp_screen"]
    if dev.type == "cuda":
        screen_launches_implied(one, one_screens, "dist run, one process")
    two = work / "dist_two"
    meta.update(fastq1=aligned["fastq1"], fastq2=aligned["fastq2"],
                shard_prefixes=split_fastq(
                    *raw_fastqs(work), str(two / "shards"),
                    reads_per_job=meta["per_shard"]))
    check(len(meta["shard_prefixes"]) == 2, "dist run: not two shards")
    (two / "meta.json").write_text(json.dumps(meta))
    t0 = time.time()
    recs = dist_ranks(two, 2)
    t_two = time.time() - t0
    for name in DIST_ARTIFACTS:
        a = (two / "out" / name).read_bytes()
        check(a == (one / name).read_bytes(),
              f"dist run: {name} differs between two processes and one")
        check(len(a) > 0, f"dist run: {name} is empty")
    counters = json.loads((two / "out" / "metrics.discover.json")
                          .read_text())["counters"]
    check(counters.get("split_dp_impl", IMPL[dev.type]) == IMPL[dev.type]
          and counters.get("em_impl") == "native",
          f"dist run: counters {counters}")
    screens = recs[0]["launches"]["split_dp_screen"]
    if dev.type == "cuda":
        screen_launches_implied(two / "out", screens, "dist run, rank 0")
    check(all(r["backend"] == "gloo" and r["world_size"] == 2
              for r in recs), f"dist run: {recs}")
    say(card, f"run on 2 processes ({n_pairs} pairs dealt into 2 shards): "
              f"{t_two:.3f} s wall from the start of the ranks (rank "
              f"seconds {[round(r['seconds'], 3) for r in recs]}), one "
              f"process {t_one:.3f} s (screen launches {one_screens}); "
              f"{len(DIST_ARTIFACTS)} artifacts byte-identical; screen "
              f"launches on rank 0 {screens}; ranks: " + "; ".join(
                  f"{r['rank']} {r['backend']} world {r['world_size']} on "
                  f"{r['device']}" for r in recs))
    say(card, f"run on 2 processes, rank 0 stages (s): {recs[0]['stages']}; "
              f"rank 1 (s): {recs[1]['stages']}")
    return {"seconds": t_two, "one_process_s": t_one, "ranks": recs,
            "screen_launches": screens}


def phase_dryrun(card, device):
    """``dryrun_multichip(2)`` with both ranks on the card."""
    from defuse_tpu_torch.entry import dryrun_multichip
    rec = dryrun_multichip(2, device=device, timeout=DIST_LIMIT_S)
    ranks = rec["ranks"]
    check(all(r["backend"] == "gloo" and r["device"].startswith(device)
              for r in ranks), f"dryrun: {ranks}")
    rowmax = [r["launches"]["split_dp_rowmax"] for r in ranks]
    check(all(k >= 3 for k in rowmax) or device == "cpu",
          f"dryrun: rowmax_kernel launches by rank {rowmax}")
    tie = [r["launches"]["split_dp_tie_columns"] for r in ranks]
    # one tie launch for both sides of a realign call that has winners
    check(device == "cpu" or all(1 <= t <= k for t, k in zip(tie, rowmax)),
          f"dryrun: tie_kernel launches by rank {tie}, rowmax {rowmax}")
    em_launches = [r["launches"]["em_rows_kernel"] for r in ranks]
    check(all(k >= 2 for k in em_launches) or device == "cpu",
          f"dryrun: em_rows_kernel launches by rank {em_launches}")
    say(card, f"dryrun_multichip(2): {rec['seconds']:.3f} s; ranks on "
              f"{[r['device'] for r in ranks]} ({ranks[0]['backend']}), "
              f"mesh {ranks[0]['mesh']['shape']}; step "
              f"{[round(r['step_s'], 3) for r in ranks]} s, one-process "
              f"discover {ranks[0]['single_s']:.3f} s, sharded discover "
              f"{[round(r['sharded_s'], 3) for r in ranks]} s; "
              f"{ranks[0]['em_rows']} EM rows and "
              f"{ranks[0]['rowmax_instances']} row-maxima instances sharded; "
              f"launches by rank: rowmax_kernel {rowmax}, tie_kernel {tie}, "
              f"em_rows_kernel {em_launches}")
    return {"seconds": rec["seconds"], "rowmax_launches": sum(rowmax),
            "tie_launches": sum(tie), "em_launches": sum(em_launches),
            "ranks": ranks}


# --- phase 14 ---------------------------------------------------------------

ROUTE_REPS = 5      # runs of each arm of an A/B, the arms alternated
COPY_REPS, RTT_REPS = 20, 200


def median_spread(xs):
    """(median, max - min) of a list of seconds."""
    return float(np.median(xs)), float(max(xs) - min(xs))


def link_rates(dev, sizes):
    """The card's host link: the host-to-device rate of pageable numpy
    memory at each of ``sizes`` ({label: bytes}; the median of COPY_REPS
    copies), and the round trip of an empty launch and a 4-byte copy back
    (the median of RTT_REPS)."""
    by_size = {}
    for label, n in sizes.items():
        a = np.ones(int(n), np.uint8)
        seconds = []
        for _ in range(COPY_REPS + 1):  # the first warms the allocator
            t0 = time.perf_counter()
            torch.from_numpy(a).to(dev)
            torch.cuda.synchronize()
            seconds.append(time.perf_counter() - t0)
        by_size[label] = {"bytes": int(n),
                          "MBps": n / float(np.median(seconds[1:])) / 1e6}
    x = torch.zeros(1, dtype=torch.int32, device=dev)
    seconds = []
    for _ in range(RTT_REPS + 1):
        t0 = time.perf_counter()
        x.add_(1)
        x.item()
        seconds.append(time.perf_counter() - t0)
    return {"bw_MBps": min(s["MBps"] for s in by_size.values()),
            "rtt_ms": float(np.median(seconds[1:])) * 1e3,
            "by_size": by_size}


def discover_ab(kw, base, reference=None):
    """Discover with ``DEFUSE_DEVICE_SCREEN=force`` and ``off``, alternated
    ROUTE_REPS times each, into fresh directories under ``base``; every
    run's artifacts equal to those in ``reference`` (by default the first
    run's).  Returns each arm's runs: wall, ``realign:emit``, the
    ``screen:*`` stages and the host part of them (read matrix, padding,
    operands), the counters."""
    import shutil
    from defuse_tpu_torch.pipeline.discover import discover_fusions
    arms = {"force": [], "off": []}
    for i in range(ROUTE_REPS):
        for mode, runs in arms.items():
            out = base / f"{mode}{i}"
            with environ(DEFUSE_DEVICE_SCREEN=mode):
                t0 = time.perf_counter()
                discover_fusions(**{**kw, "outdir": str(out)})
                wall = time.perf_counter() - t0
            reference = reference or out
            for name in ARTIFACTS:
                check((out / name).read_bytes() ==
                      (reference / name).read_bytes(),
                      f"screen {mode}: {name} differs from {reference.name}")
            metrics = json.loads((out / "metrics.discover.json").read_text())
            stages = {s["stage"].removeprefix("discover:"): s["seconds"]
                      for s in metrics["stages"]}
            runs.append({
                "wall": wall, "emit": stages["realign:emit"],
                "screen": sum(v for k, v in stages.items()
                              if k.startswith("screen:")),
                "prep": sum(stages.get(f"screen:{k}", 0.0) for k in
                            ("read_matrix", "pad", "upload")),
                "counters": metrics["counters"]})
            if out != reference:
                shutil.rmtree(out)
    return arms


def verify_ab(dev, calls):
    """The verifier at the frontend's recorded calls, on the device
    (``force``) and on the host oracle (``off``), alternated ROUTE_REPS
    times each; both routes' counts equal at every in-bounds placement
    (past the reference's end they differ: ROADMAP C4).  Then each call
    once under ``auto``: the route it takes is the cost model's.  Returns
    one record a call."""
    from defuse_tpu_torch.ops.verify_batch import (DeviceVerifier,
                                                   verify_cost_model)
    verifier = DeviceVerifier(dev)
    recs = []
    for ops in calls:
        codes, cand_pos, reads, ridx, lens = ops
        with environ(DEFUSE_DEVICE_VERIFY="force"):
            verifier(*ops)  # the plane resident, the kernel loaded
        seconds = {"device": [], "host": []}
        counts = {}
        for _ in range(ROUTE_REPS):
            for route, mode in (("device", "force"), ("host", "off")):
                with environ(DEFUSE_DEVICE_VERIFY=mode):
                    t0 = time.perf_counter()
                    counts[route] = verifier(*ops)
                    seconds[route].append(time.perf_counter() - t0)
        inside = (cand_pos >= 0) & (cand_pos + lens[ridx] <= len(codes))
        check(np.array_equal(counts["device"][inside],
                             counts["host"][inside]),
              "verify: the device and host routes' counts differ in bounds")
        t_dev, t_host = verify_cost_model(len(cand_pos), *reads.shape)
        model = "device" if t_dev < t_host else "host"
        before = verifier.calls_device
        verifier(*ops)
        taken = "device" if verifier.calls_device > before else "host"
        check(taken == model, f"verify auto took {taken}, the model {model}")
        recs.append({"candidates": len(cand_pos), "reads": reads.shape[0],
                     "L": reads.shape[1], "model": model,
                     "t_dev_s": t_dev, "t_host_s": t_host, **seconds})
    return recs


def judged(card, label, model, seconds, failures):
    """The route the model chose against the route measured faster
    (medians of ``seconds``, {route: [s, ...]}).  A model that picks the
    slower route by more than the larger arm's spread is a failure; within
    it, a near tie."""
    med = {r: median_spread(s) for r, s in seconds.items()}
    faster = min(med, key=lambda r: med[r][0])
    gap = abs(med["device"][0] - med["host"][0])
    spread = max(m[1] for m in med.values())
    verdict = "agrees" if model == faster else \
        "near tie" if gap <= spread else "WRONG"
    if verdict == "WRONG":
        failures.append(label)
    say(card, f"route {label}: model {model}, measured faster {faster} "
              f"(device {med['device'][0]:.6f} s spread "
              f"{med['device'][1]:.6f}, host {med['host'][0]:.6f} s spread "
              f"{med['host'][1]:.6f}): {verdict}")
    return {"model": model, "faster": faster, "verdict": verdict,
            "device_s": med["device"], "host_s": med["host"]}


def phase_routing(card, dev, work, dataset, run_kw, calls, em_rec):
    """Phase 14: the screen and verify A/B, the link, the rates of the cost
    models fitted from them and from phase 12, the routing table, and each
    decision against the route measured faster.  Fails, after printing
    everything, where a model picks the slower route by more than the
    measured spread."""
    from defuse_tpu_torch.align.batch_realign import _pad_len
    from defuse_tpu_torch.cluster import native
    from defuse_tpu_torch.cluster.discordant import collect_bin_pair_tasks
    from defuse_tpu_torch.cluster.matepair_em import EMParams
    from defuse_tpu_torch.core import devices
    from defuse_tpu_torch.io.sam import iter_compact, load_alignments
    from defuse_tpu_torch.ops import split_dp_cuda, verify_batch
    from defuse_tpu_torch.pipeline import routing
    from defuse_tpu_torch.pipeline.discover import discover_fusions
    from defuse_tpu_torch.utils import synth

    _ds, paths, _n_pairs = dataset
    link = devices.link_profile()
    check("override" not in link, f"link overridden: {link}")
    ncpu = native._default_threads()

    # (b) the screen, forced and off, at the discover and the run shapes
    shapes = {"discover": (discover_kwargs(paths) | {"device": dev},
                           work / "host"),
              "run": (run_kw, None)}
    screen = {}
    for shape, (kw, reference) in shapes.items():
        arms = discover_ab(kw, work / f"ab_{shape}", reference)
        counters = arms["force"][0]["counters"]
        B = int(counters["screen_candidates"])
        L = _pad_len(kw["max_read_length"], 64)
        rec = {"candidates": B, "L": L,
               "survivors": int(counters["screen_survivors"]),
               "model": routing.screen_decision(B, L, link, ncpu),
               "walls": {"device": [r["wall"] for r in arms["force"]],
                         "host": [r["wall"] for r in arms["off"]]}}
        for mode, runs in arms.items():
            for key in ("wall", "emit", "screen", "prep"):
                rec[f"{mode}_{key}"] = median_spread([r[key] for r in runs])
        route = counters["screen_route"]
        check(route["t_dev_s"] == rec["model"]["t_dev_s"],
              f"screen {shape}: recorded {route}, model {rec['model']}")
        screen[shape] = rec
        say(card, f"screen A/B at the {shape} shape ({B} candidates, "
                  f"{rec['survivors']} survivors; (median, spread) over "
                  f"{ROUTE_REPS} runs each, s): wall forced "
                  f"{rec['force_wall']}, off {rec['off_wall']}; realign:emit "
                  f"forced {rec['force_emit']}, off {rec['off_emit']}; "
                  f"screen:* {rec['force_screen']}, its host part "
                  f"{rec['force_prep']}; artifacts byte-identical")
    # the live rule once at the discover shape, with the line it prints
    split_dp_cuda.reset_launches()
    with environ(DEFUSE_STAGE_TIMING="1"):
        discover_fusions(**{**shapes["discover"][0],
                            "outdir": str(work / "auto_discover")})
    auto_route = screen_launches_implied(
        work / "auto_discover", split_dp_cuda.LAUNCHES["split_dp_screen"],
        "discover under auto")

    # (c) the verify at the frontend's calls
    verify = verify_ab(dev, calls)
    for r in verify:
        say(card, f"verify A/B at ({r['candidates']} candidates, "
                  f"{r['reads']} reads, L {r['L']}): device "
                  f"{median_spread(r['device'])}, host oracle "
                  f"{median_spread(r['host'])} s (median, spread); model "
                  f"{r['model']} (est dev {r['t_dev_s']:.6f} s, host "
                  f"{r['t_host_s']:.6f} s), taken under auto; counts equal "
                  "in bounds")

    # (a) the link, at the screen's and the largest verify call's operands
    disc = screen["discover"]
    big = max(verify, key=lambda r: r["candidates"])
    measured = link_rates(dev, {
        "screen": 2 * disc["candidates"] * disc["L"],
        "verify": 0.4 * big["reads"] * big["L"] + 8 * big["candidates"]})
    bw = measured["bw_MBps"] * 1e6
    rtt = measured["rtt_ms"] / 1e3

    # the rates, fitted as the cost models count them
    B, L = disc["candidates"], disc["L"]
    prep_share = disc["force_prep"][0] / disc["force_screen"][0]
    dev_side = disc["force_screen"][0] if prep_share > 0.1 else \
        disc["force_screen"][0] - disc["force_prep"][0]
    dev_rest = dev_side - 3 * rtt - 2 * B * L / bw
    removed = B - disc["survivors"]
    saved = disc["off_emit"][0] - disc["force_emit"][0]
    verify_rest = sum(max(float(np.median(r["device"])) - 2 * rtt - (
        0.4 * r["reads"] * r["L"] + 8 * r["candidates"]) / bw, 1e-9)
        for r in verify)
    params = EMParams(synth.MEAN, synth.STD, synth.PREC, synth.MINCL)
    instances = [(t.x, t.y, t.u) for t in collect_bin_pair_tasks(
        load_alignments(iter_compact(str(paths["spanning"]))), params)]
    native_s = []
    for _ in range(ROUTE_REPS):
        t0 = time.perf_counter()
        native.em_cluster_batch(instances, params)
        native_s.append(time.perf_counter() - t0)
    rows, stats = em_rec["rows"], em_rec["float64"]["stats"]
    fitted = {
        "LINK_BW_MBPS": measured["bw_MBps"],
        "LINK_RTT_MS": measured["rtt_ms"],
        "SCREEN_DEVICE_READS_S": B / dev_rest if dev_rest > 0 else None,
        "SCREEN_HOST_READS_S_PER_CORE":
            removed / (saved * ncpu) if saved > 0 else None,
        "DEVICE_LANES_S":
            sum(r["candidates"] * r["L"] for r in verify) / verify_rest,
        "HOST_CANDIDATES_S": sum(r["candidates"] for r in verify)
        / sum(float(np.median(r["host"])) for r in verify),
        "EM_NATIVE_ROWS_S": rows / float(np.median(native_s)),
        "EM_DEVICE_COMPUTE_ROWS_S":
            rows / (stats["wall_s"] - stats["t_upload"]),
        "EM_UPLOAD_BYTES_PER_ROW": stats["up_MB"] * 1e6 / rows,
        "EM_SLAB_ROWS": rows / stats["slabs"]}
    in_use = {"LINK_BW_MBPS": devices.LINK_BW_MBPS,
              "LINK_RTT_MS": devices.LINK_RTT_MS,
              "DEVICE_LANES_S": verify_batch.DEVICE_LANES_S,
              "HOST_CANDIDATES_S": verify_batch.HOST_CANDIDATES_S} | {
        k: getattr(routing, k) for k in fitted if hasattr(routing, k)}
    say(card, f"link measured: {measured['bw_MBps']:.1f} MB/s, the smaller "
              f"of {measured['by_size']}; round trip "
              f"{measured['rtt_ms']:.4f} ms; native threads {ncpu}")
    say(card, f"screen's device side at the discover shape: screen:* "
              f"{disc['force_screen'][0]:.6f} s, its host part "
              f"{100 * prep_share:.1f}%, so fitted to "
              + ("the whole screen:* time" if prep_share > 0.1 else
                 "the kernel and its copy back") +
              f"; realign:emit saved {saved:.6f} s for {removed} candidates "
              f"removed; native EM {median_spread(native_s)} s (median, "
              f"spread), batched EM float64 {em_rec['float64']['device_s']:.3f}"
              f" s, upload {stats['t_upload']} s, {stats['up_MB']} MB, "
              f"{stats['slabs']} slabs")
    for name, value in in_use.items():
        say(card, f"constant {name}: in use {value}, measured in this run "
                  f"{fitted[name]}")
    table = routing.routing_table(
        verify_candidates=big["candidates"], verify_reads=big["reads"],
        verify_read_len=big["L"], em_rows=rows, ncpu=ncpu)
    for name, point in table.items():
        for stage in ("screen", "verify", "em"):
            say(card, f"routing table at the bench shapes, link {name} "
                      f"{point['link']}: {stage} {point[stage]}")

    # (d) each decision against the route measured faster
    failures = []
    checks = {f"screen {shape}": judged(
        card, f"screen at the {shape} shape ({rec['candidates']} "
              "candidates; discover wall)", rec["model"]["choice"],
        rec["walls"], failures) for shape, rec in screen.items()}
    for r in verify:
        checks[f"verify {r['candidates']}"] = judged(
            card, f"verify at {r['candidates']} candidates", r["model"],
            {"device": r["device"], "host": r["host"]}, failures)
    em_model = routing.em_decision(rows, link)
    checks["em"] = judged(
        card, f"EM at {rows} rows (native against the batched EM, float64)",
        em_model["choice"], {"device": [em_rec["float64"]["device_s"]],
                             "host": native_s}, failures)
    check(not failures, f"routing: the model picks the slower route by more "
                        f"than the spread at {failures}")
    return {"link": measured, "ncpu": ncpu, "in_use": in_use,
            "measured": fitted, "prep_share": prep_share,
            "emit_saved_s": saved, "removed": removed,
            "screen": {k: {x: v for x, v in r.items() if x != "walls"}
                       for k, r in screen.items()},
            "auto_route": auto_route, "verify": verify, "table": table,
            "em_native_s": native_s, "checks": checks}


def bound(work_bytes, ops_ms):
    """(bound ms, what bounds): the larger of the least bytes over the
    card's memory rate and the least operations' time."""
    bytes_ms = work_bytes / HBM_BYTES_PER_S * 1e3
    return (bytes_ms, "bytes") if bytes_ms >= ops_ms else (ops_ms,
                                                           "operations")


def main() -> int:
    if len(sys.argv) == 5 and sys.argv[1] == "--no-native-child":
        return no_native_child(pathlib.Path(sys.argv[2]), *sys.argv[3:])
    if len(sys.argv) == 3 and sys.argv[1] == "--dist-run-child":
        return dist_run_child(pathlib.Path(sys.argv[2]))
    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is false; this script "
              "runs on an NVIDIA GPU", file=sys.stderr)
        return 1
    from defuse_tpu_torch.core.devices import gpu_identity, require_cuda
    from defuse_tpu_torch.pipeline.discover import require_native

    # --- phase 1: card ---------------------------------------------------
    dev = require_cuda("cuda")
    ident = gpu_identity()
    card = ident.splitlines()[0]
    print(ident, flush=True)
    say(card, f"torch {torch.__version__}, CUDA {torch.version.cuda}, "
              f"{torch.cuda.get_device_name(0)}")

    # --- phase 2: build --------------------------------------------------
    from concurrent.futures import ThreadPoolExecutor
    t0 = time.time()
    with ThreadPoolExecutor(len(KERNEL_SOURCES)) as pool:
        builds = {name: pool.submit(timed_build, name)
                  for name in KERNEL_SOURCES}
        require_native()
        t_native = time.time() - t0
        for name, fut in builds.items():
            seconds, report = fut.result()
            say(card, f"build: {name}.cu {seconds:.1f} s; registers: "
                      f"{kernel_registers(report) or 'cached'}")
    say(card, f"build: native library {t_native:.1f} s, all "
              f"{time.time() - t0:.1f} s")

    rng = np.random.default_rng(2024)
    # --- phase 3: kernel == plain ----------------------------------------
    err_rowmax, err_screen, err_tie = phase_kernel_equals_plain(card, dev,
                                                                rng)
    main_ms, main_plain_ms, e, main_work = phase_main_shape(card, dev, rng)
    err_screen = max(err_screen, e)
    # --- phase 4: scale --------------------------------------------------
    scale_ms, _plain, e, scale_work = phase_scale(card, dev, rng)
    err_screen = max(err_screen, e)
    (REPO / "build").mkdir(exist_ok=True)
    with tempfile.TemporaryDirectory(dir=REPO / "build") as work:
        work = pathlib.Path(work)
        dataset = bench_dataset(card, work)
        # --- phase 5: end to end -----------------------------------------
        screen_launches = phase_end_to_end(card, work, dataset)
        # --- phase 6: verify kernel == plain -----------------------------
        err_verify, verify_shapes = phase_verify(card, dev, rng)
        # --- phase 7: frontend -------------------------------------------
        verify_launches, verify_calls = phase_frontend(card, work, dataset)
        # --- phase 9: the whole run --------------------------------------
        run_launches, run_kw = phase_run(card, work, dataset, "cuda")
        # --- phase 10: discover without the native library ---------------
        no_native = phase_no_native(card, work, "cuda")
        # --- phase 11: cohort --------------------------------------------
        phase_cohort(card, work, dataset, "cuda")
        # --- phase 12: the batched EM ------------------------------------
        em_rec = phase_em(card, dataset, dev)
        # --- phase 13: the multi-process path ----------------------------
        entry_rec = phase_entry(card, dev)
        dist_rec = phase_dist_run(card, work, dataset, dev)
        dryrun_rec = phase_dryrun(card, "cuda")
        # --- phase 14: routing -------------------------------------------
        routing_rec = phase_routing(card, dev, work, dataset, run_kw,
                                    verify_calls, em_rec)
        del verify_calls
    # --- phase 8: probe and roofline -------------------------------------
    err_probe, probe_ms, probe_plain_ms, probe_work = \
        phase_probe_equals_plain(card, dev)
    phase_sass(card)
    probe_launches, probe = phase_roofline(card, dev)

    # --- bounds: least bytes at the memory rate, least operations at the
    # probe's issue rates, whichever is larger --------------------------
    from defuse_tpu_torch.ops import split_dp_census as sc
    cost, cost16 = probe["ns_per_warp_instr"], probe["ns_per_warp_instr_16x2"]
    screen_bound, screen_by = bound(
        main_work["bytes"], sc.screen_bound_ms(main_work["cells"], cost16))
    scale_bound, _by = bound(
        scale_work["bytes"], sc.screen_bound_ms(scale_work["cells"], cost16))
    verify_bounds(card, verify_shapes, cost["alu"])
    on_path = verify_shapes["B"]  # the order the frontend sends
    mix_ns = {"alu16": cost16["alu"], "dpx16": cost16["dpx"]}
    probe_bound, probe_by = bound(probe_work["bytes"], sum(
        probe_work["warps"] * probe_work["steps"] * n * mix_ns.get(
            mix, cost[k]) for mix in sc.MIXES
        for k, n in sc.MIX_STEP[mix].items()) / 1e6)

    rowmax_bound, rowmax_by = bound(
        no_native["bytes"], sc.screen_bound_ms(no_native["cells"], cost16))
    rowmax_by_path = {"no_native": no_native["launches"]["split_dp_rowmax"],
                      "entry": entry_rec["launches"],
                      "dryrun": dryrun_rec["rowmax_launches"]}
    rowmax = {
        "name": "split_dp_rowmax", "route": "cuda",
        "source": "defuse_tpu_torch/csrc/split_dp.cu",
        "replaces": "defuse_tpu/ops/split_dp_pallas.py:222",
        "launches": sum(rowmax_by_path.values()),
        "launches_by_path": rowmax_by_path,
        "max_abs_err": max(err_rowmax, no_native["err"]),
        "ms": no_native["ms"], "plain_ms": no_native["plain_ms"],
        "bound_ms": rowmax_bound, "bound_by": rowmax_by, "library_ms": None,
        "call_ms": no_native["call_ms"],
        "census_ms": sc.census_ms(no_native["census"], cost16),
        "instances": no_native["instances"], "R": no_native["R"],
        "L": no_native["L"], "cells": no_native["cells"],
        "entry": {k: entry_rec[k] for k in ("ms", "plain_ms")}}
    # the route's one tie call of both sides
    ties = no_native["tie"]
    for t in ties:
        t["bound_ms"], t["bound_by"] = bound(
            t["bytes"], sc.screen_bound_ms(t["cells"], cost16))
    slow = max(ties, key=lambda t: t["ms"])
    tie_by_path = {"no_native": no_native["launches"]["split_dp_tie_columns"],
                   "dryrun": dryrun_rec["tie_launches"]}
    tie = {"name": "split_dp_tie_columns", "route": "cuda",
           "source": "defuse_tpu_torch/csrc/split_dp.cu",
           "replaces": "defuse_tpu/ops/split_dp_batch.py:113",
           "launches": sum(tie_by_path.values()),
           "launches_by_path": tie_by_path,
           "max_abs_err": max(err_tie, *(t["err"] for t in ties)),
           "ms": slow["ms"], "plain_ms": slow["plain_ms"],
           "bound_ms": slow["bound_ms"], "bound_by": slow["bound_by"],
           "library_ms": None, "call_ms": slow["call_ms"], "calls": ties,
           "launch_floor_ms": no_native["tie_variants"]["floor"]["ms"],
           "lone_pair_ms": no_native["tie_variants"]["lone_pair"]["ms"],
           "variants": no_native["tie_variants"]}
    say(card, f"rowmax_kernel's own instructions on the route (the census of "
              f"its row loop, {no_native['census']}) at the probe's rates: "
              f"{rowmax['census_ms']:.4f} ms, "
              f"{100 * rowmax['census_ms'] / rowmax['ms']:.1f}% of its time")
    for k in (rowmax, tie):
        say(card, f"{k['name']} on the no-native route: "
                  f"{k['launches_by_path']['no_native']} launches; kernel "
                  f"{k['ms']:.4f} ms, bound {k['bound_ms']:.4f} ms by "
                  f"{k['bound_by']} ({100 * k['bound_ms'] / k['ms']:.1f}% of "
                  f"bound), wrapper call {k['call_ms']:.4f} ms, plain "
                  f"{k['plain_ms']:.3f} ms, max_abs_err {k['max_abs_err']}")
    # the EM: its launches on each path that runs it on the card; its time
    # the kernel alone on phase 12's whole batch (float64, one launch)
    em_by_path = {
        "no_native_device_em":
            no_native["device_em"]["launches"]["em_rows_kernel"],
        "run_batch": em_rec["launches"],
        "dryrun": dryrun_rec["em_launches"]}
    em_kernel = {
        "name": "em_rows_kernel", "route": "cuda",
        "source": "defuse_tpu_torch/csrc/em.cu",
        "replaces": "defuse_tpu/cluster/matepair_em_batch.py:453",
        "launches": sum(em_by_path.values()),
        "launches_by_path": em_by_path,
        "max_abs_err": em_rec["max_abs_err"], "ms": em_rec["kernel_ms"],
        "plain_ms": em_rec["plain_ms"], "bound_ms": em_rec["bound_ms"],
        "bound_by": em_rec["bound_by"], "library_ms": None,
        "call_ms": em_rec["call_ms"], "rows": em_rec["rows"],
        "bound_most_ms": em_rec["bound_most_ms"],
        "ms_per_batch_iteration": em_rec["ms_per_batch_iteration"],
        "m_step_share": em_rec["phases"]["m_step_share"]}
    say(card, f"em_rows_kernel: launches by path {em_by_path}; the whole "
              f"batch ({em_rec['rows']} rows) in one launch "
              + (f"{em_rec['kernel_ms']:.3f} ms, bound "
                 f"{em_rec['bound_ms']:.4f} ms by {em_rec['bound_by']} "
                 f"({100 * em_rec['bound_ms'] / em_rec['kernel_ms']:.2f}% "
                 f"of bound)" if em_rec["kernel_ms"] else "not measured")
              + f", the plain loop {em_rec['plain_ms']:.1f} ms; max |a, b| "
              f"difference {em_rec['max_abs_err']:.3e}")
    say(card, f"screen at scale: {scale_ms:.3f} ms, bound {scale_bound:.3f} "
              f"ms ({100 * scale_bound / scale_ms:.1f}% of bound, "
              f"{scale_work['cells']} cells)")
    kernels = [{
        "name": "split_dp_screen", "route": "cuda",
        "source": "defuse_tpu_torch/csrc/split_dp.cu",
        "replaces": "defuse_tpu/ops/split_dp_pallas.py:222",
        "launches": screen_launches["split_dp_screen"]
        + run_launches["split_dp_screen"] + dist_rec["screen_launches"],
        "launches_by_path": {
            "discover": screen_launches["split_dp_screen"],
            "run": run_launches["split_dp_screen"],
            "dist_run": dist_rec["screen_launches"]},
        "max_abs_err": err_screen, "ms": main_ms,
        "plain_ms": main_plain_ms, "bound_ms": screen_bound,
        "bound_by": screen_by, "library_ms": None}, rowmax, tie, {
        "name": "verify_packed3", "route": "cuda",
        "source": "defuse_tpu_torch/csrc/verify.cu",
        "replaces": "defuse_tpu/ops/verify_batch.py:86",
        "launches": verify_launches["verify_packed3"]
        + run_launches["verify_packed3"],
        "launches_by_path": {
            "align_reads": verify_launches["verify_packed3"],
            "run": run_launches["verify_packed3"]},
        "max_abs_err": err_verify, "ms": on_path["ms"],
        "plain_ms": on_path["plain_ms"], "bound_ms": on_path["bound_ms"],
        "bound_by": on_path["bound_by"], "library_ms": None,
        "shapes": verify_shapes}, {
        "name": "issue_probe", "route": "cuda",
        "source": "defuse_tpu_torch/csrc/issue_probe.cu",
        "replaces": "defuse_tpu/ops/split_dp_census.py:143",
        "launches": probe_launches["issue_probe"],
        "max_abs_err": err_probe, "ms": probe_ms,
        "plain_ms": probe_plain_ms, "bound_ms": probe_bound,
        "bound_by": probe_by, "library_ms": None}, em_kernel]
    say(card, "kernels at the main path's shapes (no PyTorch call computes "
              "any of the six functions): " + "; ".join(
                  f"{k['name']} {k['ms']:.4f} ms, {k['launches']} launches, "
                  f"bound {k['bound_ms']:.4f} ms by {k['bound_by']} "
                  f"({100 * k['bound_ms'] / k['ms']:.1f}%)" for k in kernels))
    print(json.dumps({"em": em_rec,
                      "no_native_device_em": no_native["device_em"],
                      "dist_run": dist_rec, "dryrun": dryrun_rec,
                      "routing": routing_rec}),
          flush=True)
    print(json.dumps({"kernels": kernels}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
