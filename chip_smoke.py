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
   L, N on either side, repeated reads), then timed at the bench's verify
   microbench shape (4,000,000 bases, 20,000 reads of 50 bp, 65,536 and
   524,288 candidates): marginal candidates/s of kernel and plain;
7. frontend: the port's ``align_reads`` on the bench dataset's reads with
   ``DEFUSE_DEVICE_VERIFY=force`` (the Python seed path, every candidate
   verified by the kernel) and on the native route, artifacts
   byte-identical, the kernel's launches counted, both wall times;
8. probe and roofline: each issue-probe mix = its plain version exactly;
   the census of the probe's loops and of every row loop of the screen
   kernels against the machine code (``cuobjdump -sass``), within 20% per
   class; the screen's roofline (its time against the work-based bound
   and against its own census), with the probe's launches counted.

All kernel comparisons are exact (integer results; tolerance 0).  Each
kernel's bound is the larger of its least bytes over the card's memory
rate and its least operations at the probe's measured issue rates.  Prints
a line of each kernel's time, launches and bound, a JSON line of
per-kernel results, then ``{"ok": true, "device": ...}`` last.
"""

from __future__ import annotations

import json
import pathlib
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


def bench_dataset(card, work):
    from defuse_tpu_torch.utils import synth
    t0 = time.time()
    ds, paths, n_pairs = synth.build_dataset(work)
    say(card, f"bench dataset: {n_pairs} read pairs in "
              f"{time.time() - t0:.2f} s")
    return ds, paths, n_pairs


def phase_end_to_end(card, work, dataset):
    from defuse_tpu_torch.ops import split_dp_cuda
    from defuse_tpu_torch.utils import synth
    from defuse_tpu_torch.pipeline.discover import discover_fusions

    _ds, paths, n_pairs = dataset
    kw = dict(spanning=str(paths["spanning"]),
              improper=str(paths["improper"]),
              fastq1=str(paths["fastq1"]), fastq2=str(paths["fastq2"]),
              reference=str(paths["reference"]), exons=str(paths["exons"]),
              fragment_mean=synth.MEAN, fragment_stddev=synth.STD,
              precision=synth.PREC, min_cluster_size=synth.MINCL,
              min_read_length=synth.MINREAD, max_read_length=synth.MAXREAD)
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

VERIFY_N, VERIFY_READS, VERIFY_READ = 4_000_000, 20_000, 50
VERIFY_BATCHES = (65_536, 524_288)


def phase_verify(card, dev, rng):
    from defuse_tpu_torch.convert import verify_operands
    from defuse_tpu_torch.ops.verify_batch import verify_packed3_ref
    from defuse_tpu_torch.ops.verify_cuda import verify_packed3
    from defuse_tpu_torch.utils.synth import verify_case

    codes, starts, reads, ridx, lens = verify_case(int(rng.integers(1 << 30)))
    ops = verify_operands(codes, starts, reads, ridx, lens, dev)
    L = reads.shape[1]
    want = verify_packed3_ref(*ops, L)
    got = verify_packed3(*ops, L)
    err = int((got - want).abs().max())
    check(err == 0, "verify kernel differs from plain on the edge cases")
    check(int(want.max()) > 0 and int((want == 0).sum()) > 0,
          "edge cases hold no mismatch or no exact match")
    say(card, f"verify kernel == plain (exact) on {len(starts)} edge-case "
              "candidates")

    codes = rng.integers(0, 4, VERIFY_N).astype(np.int8)
    reads = rng.integers(0, 4, (VERIFY_READS, VERIFY_READ)).astype(np.int8)
    lens = np.full(VERIFY_READS, VERIFY_READ, np.int32)
    C = VERIFY_BATCHES[-1]
    starts = rng.integers(0, VERIFY_N - VERIFY_READ, C)
    ridx = rng.integers(0, VERIFY_READS, C).astype(np.int32)
    ref3, w10, l10, reads3, ridx_t, lens_t = verify_operands(
        codes, starts, reads, ridx, lens, dev)
    times = {}
    # the kernel from a CUDA graph of 20 launches (a launch takes less time
    # than the host's wrapper call); the plain version's ops run longer
    for name, fn, graph in (("kernel", verify_packed3, True),
                            ("plain", verify_packed3_ref, False)):
        for c in VERIFY_BATCHES:
            args = (ref3, w10[:c], l10[:c], reads3, ridx_t[:c], lens_t,
                    VERIFY_READ)
            times[name, c] = time_ms(lambda: fn(*args), 20, graph=graph,
                                     rounds=3)
    full = (ref3, w10, l10, reads3, ridx_t, lens_t, VERIFY_READ)
    e = int((verify_packed3(*full) - verify_packed3_ref(*full)).abs().max())
    check(e == 0, "verify kernel differs from plain at the microbench shape")
    for name in ("kernel", "plain"):
        t_small, t_big = times[name, VERIFY_BATCHES[0]], times[name, C]
        marginal = (t_big - t_small) / (C - VERIFY_BATCHES[0])  # ms/cand
        say(card, f"verify {name}: {t_big:.3f} ms for {C} candidates, "
                  f"{t_small:.3f} ms for {VERIFY_BATCHES[0]}; marginal "
                  f"{1e3 / marginal:.0f} candidates/s "
                  f"({VERIFY_READ * 1e3 / marginal:.0f} bases/s)")
    # least bytes: every operand read once (the plane, the reads, 12 B of
    # indices a candidate), 4 B a candidate written
    work = {"candidates": C, "words": C * reads3.shape[1],
            "bytes": sum(t.numel() * t.element_size() for t in full[:6])
            + 4 * C}
    return max(err, e), times["kernel", C], times["plain", C], work


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
              f"{len(a['spanning'])} B); launches {launches}")
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


def bound(work_bytes, ops_ms):
    """(bound ms, what bounds): the larger of the least bytes over the
    card's memory rate and the least operations' time."""
    bytes_ms = work_bytes / HBM_BYTES_PER_S * 1e3
    return (bytes_ms, "bytes") if bytes_ms >= ops_ms else (ops_ms,
                                                           "operations")


def main() -> int:
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
        err_verify, verify_ms, verify_plain_ms, verify_work = \
            phase_verify(card, dev, rng)
        # --- phase 7: frontend -------------------------------------------
        verify_launches = phase_frontend(card, work, dataset)
    # --- phase 8: probe and roofline -------------------------------------
    err_probe, probe_ms, probe_plain_ms, probe_work = \
        phase_probe_equals_plain(card, dev)
    phase_sass(card)
    probe_launches, probe = phase_roofline(card, dev)

    # --- bounds: least bytes at the memory rate, least operations at the
    # probe's issue rates, whichever is larger --------------------------
    from defuse_tpu_torch.ops import split_dp_census as sc
    from defuse_tpu_torch.ops.verify_cuda import OPS_PER_WORD
    cost, cost16 = probe["ns_per_warp_instr"], probe["ns_per_warp_instr_16x2"]
    screen_bound, screen_by = bound(
        main_work["bytes"], sc.screen_bound_ms(main_work["cells"], cost16))
    scale_bound, _by = bound(
        scale_work["bytes"], sc.screen_bound_ms(scale_work["cells"], cost16))
    verify_bound, verify_by = bound(
        verify_work["bytes"],
        verify_work["words"] * OPS_PER_WORD / sc.WARP * cost["alu"] / 1e6)
    mix_ns = {"alu16": cost16["alu"], "dpx16": cost16["dpx"]}
    probe_bound, probe_by = bound(probe_work["bytes"], sum(
        probe_work["warps"] * probe_work["steps"] * n * mix_ns.get(
            mix, cost[k]) for mix in sc.MIXES
        for k, n in sc.MIX_STEP[mix].items()) / 1e6)

    say(card, f"rowmax entry (dp_row_maxima_cuda, off the discover path): "
              f"max_abs_err {err_rowmax}")
    say(card, f"screen at scale: {scale_ms:.3f} ms, bound {scale_bound:.3f} "
              f"ms ({100 * scale_bound / scale_ms:.1f}% of bound, "
              f"{scale_work['cells']} cells)")
    kernels = [{
        "name": "split_dp_screen", "route": "cuda",
        "source": "defuse_tpu_torch/csrc/split_dp.cu",
        "replaces": "defuse_tpu/ops/split_dp_pallas.py:222",
        "launches": screen_launches["split_dp_screen"],
        "max_abs_err": err_screen, "ms": main_ms,
        "plain_ms": main_plain_ms, "bound_ms": screen_bound,
        "bound_by": screen_by, "library_ms": None}, {
        "name": "verify_packed3", "route": "cuda",
        "source": "defuse_tpu_torch/csrc/verify.cu",
        "replaces": "defuse_tpu/ops/verify_batch.py:86",
        "launches": verify_launches["verify_packed3"],
        "max_abs_err": err_verify, "ms": verify_ms,
        "plain_ms": verify_plain_ms, "bound_ms": verify_bound,
        "bound_by": verify_by, "library_ms": None}, {
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
