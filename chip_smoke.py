#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port on one NVIDIA GPU.

    python3 chip_smoke.py

Phases (any failure raises and exits non-zero; nothing is caught):

1. card: nvidia-smi name and power limit, CUDA version; CUDA is required;
2. build: the native host library and the three CUDA kernels, from
   source (one ``nvcc`` each, all started together);
3. kernel = plain version, exactly, in both launch modes over a sweep of
   flank/read widths and edge rows and over the edge cases of
   ``defuse_tpu_torch.utils.synth.EDGE_CASES`` (flank widths off the lane
   grid, flanks far shorter than the table, lengths 0, 1,024-base reads
   that match or mismatch everywhere: the int16 range), and timed at the
   discover path's screen shape;
4. scale: the screen over a tumour-library candidate set (1,048,576
   reads of 100 bp against 4,096 flank pairs up to 480 bp): kernel time,
   an exact check against the plain version on a 65,536-read subsample,
   and survivors == the planted junction reads;
5. end to end: ``defuse_tpu_torch`` discover on the 92,800-pair bench
   dataset, its artifacts byte-identical to its own host-only run
   (``use_device=False``: every candidate realigned, no screen), with the
   screen kernel's launches counted.  Identity with ``defuse_tpu`` itself
   is held by ``tests/test_torch_discover.py``;
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
   counted, both wall times;
8. probe and roofline: each issue-probe mix = its plain version exactly;
   the census of the probe's loops and of every row loop of the screen
   kernels against the machine code (``cuobjdump -sass``), within 20% per
   class; the screen's roofline (its time against the work-based bound
   and against its own census), with the probe's launches counted;
9. the whole ``run``: ``create-ref`` and then ``run`` through
   ``defuse_tpu_torch.cli.main.main`` on the bench dataset's raw fastqs
   (92,800 pairs, 96 planted fusions; genome, gene models and repeats
   written by ``utils.synth.write_run_config``), once on the card and once
   with ``--no-device``: results, annotations and discover artifacts
   byte-identical between the two, every planted gene pair in
   ``results.classify.tsv``, ``split_dp_impl == "cuda"``, the screen's
   launches counted, and the stage seconds of both runs;
10. discover without the native library, in a child process with
   ``DEFUSE_NO_NATIVE=1``, on the dataset cut to NO_NATIVE_FUSIONS fusions
   and NO_NATIVE_BACKGROUND background pairs (the Python EM and the Python
   realign take seconds there): artifacts byte-identical to the native
   route's on the same input, ``rowmax_kernel``'s launches counted, the
   kernel against its plain version and timed on the route's own operands,
   ``dp_tie_columns`` on the card equal to the same call on CPU tensors bit
   for bit and timed;
11. ``cohort``: the bench reads dealt out into two libraries, through
   ``cli.main.main(["cohort", ...])`` with two workers sharing the card;
   both libraries ``ok``, ``cohort_fusions.tsv`` not empty.

All kernel comparisons are exact (integer results; tolerance 0).  Each
kernel's bound is the larger of its least bytes over the card's memory
rate and its least operations at the probe's measured issue rates; the
verify's is printed for each of its shapes, beside the same bytes counted
in 32 B sectors.  Prints a line of each kernel's time, launches and bound,
a JSON line of per-kernel results (the verify's at shape B, the order the
main path sends, with all three shapes under ``shapes``), then
``{"ok": true, "device": ...}`` last.
"""

from __future__ import annotations

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


KERNEL_SOURCES = ("split_dp", "verify", "issue_probe")


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


def phase_kernel_equals_plain(card, dev, rng):
    from defuse_tpu_torch.convert import screen_operands
    from defuse_tpu_torch.ops.split_dp_batch import (dp_row_maxima,
                                                     screen_candidates_ref)
    from defuse_tpu_torch.ops.split_dp_cuda import (dp_row_maxima_cuda,
                                                    screen_candidates)
    from defuse_tpu_torch.utils.synth import EDGE_CASES, edge_case
    err_rowmax = err_screen = 0
    shapes = ((60, 24), (90, 24), (100, 24), (130, 64), (128, 64),
              (257, 64), (384, 64), (512, 128))
    for R, L in shapes:
        rowmax_in, screen_in = sweep_case(rng, R, L)
        ts = [torch.from_numpy(a).to(dev) for a in rowmax_in]
        want = dp_row_maxima(*ts)
        got = dp_row_maxima_cuda(*ts)
        e = int((got - want).abs().max())
        err_rowmax = max(err_rowmax, e)
        check(e == 0, f"rowmax kernel differs from plain at R={R} L={L}")
        ops = screen_operands(*screen_in, dev)
        want = screen_candidates_ref(*ops)
        got = screen_candidates(*ops)
        e = int((got - want).abs().max())
        err_screen = max(err_screen, e)
        check(e == 0, f"screen kernel differs from plain at R={R} L={L}")
        check(int((want > 0).sum()) > 0, f"no survivor at R={R} L={L}")
    say(card, f"kernel == plain (exact) in both modes at (R, L) = {shapes}")
    for name in sorted(EDGE_CASES):
        rowmax_in, screen_in = edge_case(name)
        ts = [torch.from_numpy(a).to(dev) for a in rowmax_in]
        e = int((dp_row_maxima_cuda(*ts) - dp_row_maxima(*ts)).abs().max())
        err_rowmax = max(err_rowmax, e)
        check(e == 0, f"rowmax kernel differs from plain on {name}")
        ops = screen_operands(*screen_in, dev)
        want = screen_candidates_ref(*ops)
        e = int((screen_candidates(*ops) - want).abs().max())
        err_screen = max(err_screen, e)
        check(e == 0, f"screen kernel differs from plain on {name}")
        check(int(want.max()) > 0, f"no survivor on {name}")
    say(card, "kernel == plain (exact) in both modes on the edge cases "
              f"{sorted(EDGE_CASES)}")
    return err_rowmax, err_screen


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
    say(card, f"discover: port {t_port:.3f} s ({n_pairs / t_port:.0f} "
              f"pairs/s), host-only run (no screen) {t_host:.3f} s; "
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

    from defuse_tpu_torch.align.frontend import align_reads
    from defuse_tpu_torch.ops import verify_cuda
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

    verify_cuda.reset_launches()
    os.environ["DEFUSE_DEVICE_VERIFY"] = "force"
    try:
        t0 = time.time()
        forced = align_reads(config, str(work / "fe_device"), *fq,
                             device="cuda")
        t_device = time.time() - t0
    finally:
        del os.environ["DEFUSE_DEVICE_VERIFY"]
    launches = dict(verify_cuda.LAUNCHES)

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
    return launches


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
    rows = sc.screen_row_loops(text)
    shapes = sorted({sc.shape_for(R) for R in range(1, 1024)})
    check(sorted(rows) == shapes,
          f"screen kernels in the SASS {sorted(rows)}, expected {shapes}")
    for lanes, cmax in shapes:
        # one row loop per column count of the kernel's switch
        found = rows[lanes, cmax]
        check(sorted(found) == list(range(1, cmax + 1)),
              f"screen_kernel<{cmax}, {lanes}>: row loops for C = "
              f"{sorted(found)}, expected 1..{cmax}")
        for C, lp in sorted(found.items()):
            want = sc.row_census(C, lanes, cmax)["total"]
            flush = sc.flush_census(lanes)["static"]
            want = {k: want[k] + flush[k] for k in sc.CLASSES}
            miss = sc.census_mismatches(want, lp["per_row"])
            bad += [f"screen<{cmax}, {lanes}> C={C} {m}" for m in miss]
            if miss or C in (1, cmax):
                say(card, f"SASS screen_kernel<{cmax}, {lanes}> C={C} row "
                          f"loop ({lp['rows_per_trip']} row per trip, "
                          f"{lp['nested']} nested): "
                          f"{class_row(lp['per_row'])}; census (row + the "
                          f"flush's static part) {class_row(want)}; "
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
    timed from outside while a ``run`` goes through the command line."""

    def __enter__(self):
        from defuse_tpu_torch.align import frontend
        from defuse_tpu_torch.pipeline.runner import Runner
        self.seconds = {}
        self._saved = (frontend.align_reads, Runner.run)
        align_reads, run = self._saved

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
        return self

    def __exit__(self, *exc):
        from defuse_tpu_torch.align import frontend
        from defuse_tpu_torch.pipeline.runner import Runner
        frontend.align_reads, Runner.run = self._saved

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
    check(counters.get("split_dp_impl") == IMPL[device],
          f"run: split_dp_impl is {counters.get('split_dp_impl')!r}")
    check(launches["split_dp_screen"] >= 1, "run: screen never launched")
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
              f"past the probability threshold; launches {launches}; screen "
              f"{int(counters['screen_candidates'])} candidates, "
              f"{int(counters['screen_survivors'])} survivors")
    say(card, "run stages on the card (s): "
              f"{card_clock.stages(work / 'run_card')}")
    say(card, "run stages --no-device (s): "
              f"{host_clock.stages(work / 'run_host')}")
    return launches


# --- phase 10 ---------------------------------------------------------------

NO_NATIVE_FUSIONS, NO_NATIVE_BACKGROUND = 12, 3000


def no_native_child(work, device):
    """Phase 10's child process (``DEFUSE_NO_NATIVE=1``): discover on the
    cut dataset under ``work`` through the Python EM and the Python
    realign, the row maxima and tie columns on ``device``.  Prints one JSON
    line: launches, the kernel against its plain version and both timed on
    the route's own operands, ``dp_tie_columns`` on ``device`` against the
    same call on CPU tensors."""
    from defuse_tpu_torch.cluster import native
    from defuse_tpu_torch.ops import split_dp_batch, split_dp_cuda
    from defuse_tpu_torch.pipeline import discover
    check(not native.available(), "the child has the native library")
    paths = {k: work / v for k, v in (
        ("spanning", "spanning.compact"), ("improper", "improper.sam"),
        ("fastq1", "reads.1.fastq"), ("fastq2", "reads.2.fastq"),
        ("reference", "reference.fa"), ("exons", "cdna.regions"))}
    seen = {"rowmax": [], "tie": []}
    rowmax, tie = discover.dp_row_maxima_cuda, split_dp_batch.dp_tie_columns
    discover.dp_row_maxima_cuda = \
        lambda *ops: seen["rowmax"].append(ops) or rowmax(*ops)
    split_dp_batch.dp_tie_columns = \
        lambda *ops: seen["tie"].append(ops) or tie(*ops)
    split_dp_cuda.reset_launches()
    t0 = time.time()
    discover.discover_fusions(outdir=str(work / "no_native"), device=device,
                              em_mode="oracle", **discover_kwargs(paths))
    seconds = time.time() - t0
    launches = dict(split_dp_cuda.LAUNCHES)
    check(len(seen["rowmax"]) == 1 and len(seen["tie"]) == 2,
          f"route called rowmax {len(seen['rowmax'])} and dp_tie_columns "
          f"{len(seen['tie'])} times")

    ops = seen["rowmax"][0]
    want = split_dp_batch.dp_row_maxima(*ops)
    err = int((rowmax(*ops) - want).abs().max())
    check(int(want.max()) > 0, "no-native: no row clears the anchor")
    ref_lens, read_lens = (t.cpu().numpy().astype(np.int64)
                           for t in (ops[1], ops[3]))
    rec = {"seconds": seconds, "launches": launches, "err": err,
           "instances": int(ops[0].shape[0]),
           "R": int(ops[0].shape[1]), "L": int(ops[2].shape[1]),
           "ms": time_ms(lambda: rowmax(*ops), 10),
           "plain_ms": time_ms(
               lambda: split_dp_batch.dp_row_maxima(*ops), 2),
           "cells": int((read_lens * (ref_lens + 1)).sum()),
           "bytes": sum(t.numel() * t.element_size() for t in ops)
           + 4 * want.numel(), "tie": []}
    for ops in seen["tie"]:
        got = tie(*ops)
        cpu = tie(*(t.cpu() for t in ops))
        check(all(torch.equal(g.cpu(), c) for g, c in zip(got, cpu)),
              "dp_tie_columns on the card differs from CPU tensors")
        check(bool(cpu[1].any()), "dp_tie_columns: no tie column set")
        rec["tie"].append({"winners": int(ops[0].shape[0]),
                           "rows": int(ops[4].shape[1]),
                           "ms": time_ms(lambda: tie(*ops), 3)})
    check_no_reference_modules()
    print(json.dumps(rec), flush=True)
    return 0


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
    proc = subprocess.run(
        [sys.executable, str(REPO / "chip_smoke.py"), "--no-native-child",
         str(cut), device], env=dict(os.environ, DEFUSE_NO_NATIVE="1"),
        capture_output=True, text=True, timeout=600, cwd=REPO)
    check(proc.returncode == 0,
          f"no-native child failed: {proc.stderr[-3000:]}")
    rec = json.loads(proc.stdout.strip().splitlines()[-1])
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
    check(rec["launches"]["split_dp_rowmax"] >= 1,
          "no-native: rowmax kernel never launched")
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
              f"instances, R={rec['R']}, L={rec['L']}): {rec['ms']:.4f} ms, "
              f"plain {rec['plain_ms']:.3f} ms, max_abs_err {rec['err']}; "
              f"dp_tie_columns (torch, == CPU tensors bit for bit): " +
              "; ".join(f"{t['winners']} winners x {t['rows']} rows "
                        f"{t['ms']:.3f} ms" for t in rec["tie"]))
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
    for lib in libs:
        counters = json.loads((work / "cohort" / lib /
                               "metrics.discover.json").read_text())
        check(counters["counters"].get("split_dp_impl") == IMPL[device],
              f"cohort {lib}: split_dp_impl")
    recurrent = len((work / "cohort" / "cohort_recurrent.tsv").read_text()
                    .splitlines()) - 1
    say(card, f"cohort of {len(libs)} libraries ({n_pairs // 2} pairs each, "
              f"2 workers sharing the card): {seconds:.3f} s; both ok "
              f"(n_fusions {[r[2] for r in summary]}, seconds "
              f"{[r[3] for r in summary]}); {len(fusions) - 1} pooled "
              f"fusions, {recurrent} gene pairs in cohort_recurrent.tsv")


def bound(work_bytes, ops_ms):
    """(bound ms, what bounds): the larger of the least bytes over the
    card's memory rate and the least operations' time."""
    bytes_ms = work_bytes / HBM_BYTES_PER_S * 1e3
    return (bytes_ms, "bytes") if bytes_ms >= ops_ms else (ops_ms,
                                                           "operations")


def main() -> int:
    if len(sys.argv) == 4 and sys.argv[1] == "--no-native-child":
        return no_native_child(pathlib.Path(sys.argv[2]), sys.argv[3])
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
    err_rowmax, err_screen = phase_kernel_equals_plain(card, dev, rng)
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
        verify_launches = phase_frontend(card, work, dataset)
        # --- phase 9: the whole run --------------------------------------
        run_launches = phase_run(card, work, dataset, "cuda")
        # --- phase 10: discover without the native library ---------------
        no_native = phase_no_native(card, work, "cuda")
        # --- phase 11: cohort --------------------------------------------
        phase_cohort(card, work, dataset, "cuda")
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
    rowmax = {"launches": no_native["launches"]["split_dp_rowmax"],
              "max_abs_err": max(err_rowmax, no_native["err"]),
              "instances": no_native["instances"], "R": no_native["R"],
              "L": no_native["L"], "cells": no_native["cells"],
              "ms": no_native["ms"], "plain_ms": no_native["plain_ms"],
              "bound_ms": rowmax_bound, "bound_by": rowmax_by,
              "library_ms": None, "dp_tie_columns": no_native["tie"]}
    say(card, f"rowmax_kernel on the no-native route: {rowmax['launches']} "
              f"launch for {rowmax['instances']} instances, "
              f"{rowmax['ms']:.4f} ms, bound {rowmax_bound:.4f} ms by "
              f"{rowmax_by} ({100 * rowmax_bound / rowmax['ms']:.1f}% of "
              f"bound, {rowmax['cells']} cells), plain "
              f"{rowmax['plain_ms']:.3f} ms, max_abs_err "
              f"{rowmax['max_abs_err']}")
    say(card, f"screen at scale: {scale_ms:.3f} ms, bound {scale_bound:.3f} "
              f"ms ({100 * scale_bound / scale_ms:.1f}% of bound, "
              f"{scale_work['cells']} cells)")
    kernels = [{
        "name": "split_dp_screen", "route": "cuda",
        "source": "defuse_tpu_torch/csrc/split_dp.cu",
        "replaces": "defuse_tpu/ops/split_dp_pallas.py:222",
        "launches": screen_launches["split_dp_screen"]
        + run_launches["split_dp_screen"],
        "launches_by_path": {
            "discover": screen_launches["split_dp_screen"],
            "run": run_launches["split_dp_screen"]},
        "max_abs_err": err_screen, "ms": main_ms,
        "plain_ms": main_plain_ms, "bound_ms": screen_bound,
        "bound_by": screen_by, "library_ms": None,
        "rowmax_kernel": rowmax}, {
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
        "bound_by": probe_by, "library_ms": None}]
    say(card, "kernels at the main path's shapes (no PyTorch call computes "
              "any of the three functions): " + "; ".join(
                  f"{k['name']} {k['ms']:.4f} ms, {k['launches']} launches, "
                  f"bound {k['bound_ms']:.4f} ms by {k['bound_by']} "
                  f"({100 * k['bound_ms'] / k['ms']:.1f}%)" for k in kernels))
    print(json.dumps({"kernels": kernels}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
