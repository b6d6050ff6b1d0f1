"""Fusion discovery on the card: cluster -> set cover -> split align -> vote.

Counterpart of ``defuse_tpu/pipeline/discover.py``, with the same stages
and byte-identical artifacts, on both of its routes:

* with the native host library, clustering and realignment run in C++ and
  the one device stage is the split-read DP screen
  (``ops/split_dp_cuda.screen_candidates``), which drops the candidate
  reads no split alignment would accept; the native driver realigns the
  survivors;
* without it (``DEFUSE_NO_NATIVE=1`` or no compiler), clustering is the
  port's Python EM and the realign is ``align/batch_realign``: DP row
  maxima from ``ops/split_dp_cuda.dp_row_maxima_cuda``, tie columns from
  ``ops/split_dp_batch.dp_tie_columns``.

The device stages run as CUDA kernels (``device="cuda"``) or, only when
``device="cpu"`` is passed or ``use_device`` is false, as their plain
PyTorch versions on CPU tensors.
"""

from __future__ import annotations

import os
import pathlib

import numpy as np
import torch

from ..align.batch_realign import (_pad_len, collect_candidates,
                                   realign_candidates)
from ..align.tasks import (SplitReadRealigner, create_tasks, evaluate_file,
                           read_align_region_pairs)
from ..cluster import native
from ..cluster.discordant import cluster_alignments, write_clusters
from ..cluster.matepair_em import EMParams
from ..cluster.setcover import run_setcover_file
from ..convert import screen_min_scores, screen_operands
from ..core.devices import require_cuda
from ..core.exons import ExonRegions
from ..io.fasta import FastaStore
from ..io.sam import iter_compact, iter_sam, load_alignments
from ..ops.split_dp_batch import pad_batch
from ..ops.split_dp_cuda import dp_row_maxima_cuda, screen_candidates
from ..utils import checks
from ..utils.profiling import Tracer, device_trace
from .regions import align_regions_file


EM_MODES = ("auto", "native", "oracle")


def require_native() -> None:
    """Build the native host library if needed; raise when it is missing.
    For callers that mean to measure the native route; ``discover_fusions``
    itself runs without the library."""
    if not native.available():
        raise RuntimeError(
            "the native host library is missing "
            "(bash native/build.sh; DEFUSE_NO_NATIVE must be unset)")


def discover_fusions(spanning, improper, fastq1, fastq2, reference, exons,
                     fragment_mean, fragment_stddev, precision,
                     min_cluster_size, min_read_length, max_read_length,
                     outdir, use_device=True, em_mode="auto",
                     gene_models=None, mt_chromosome="MT",
                     dna_concordant_length=2000, dist=None,
                     reads_sources=None, device="cuda"):
    """Run discovery into ``outdir``; returns the artifact paths.

    ``use_device`` puts the device stages on ``device``: the split-read
    screen with the native library (``DEFUSE_DEVICE_SCREEN=off`` disables
    it), the row maxima and tie columns of the Python realign without it.
    ``em_mode`` is "auto" (the native EM when the library is built),
    "native" or "oracle" (the Python EM, exact); without the library "auto"
    with ``use_device`` would mean the batched device EM, which is not
    ported (ROADMAP B6/A11) and raises.  One process: ``dist`` with more
    than one and ``reads_sources`` raise (ROADMAP B7/A12).
    """
    if em_mode not in EM_MODES:
        raise ValueError(f"em_mode {em_mode!r}: the port runs "
                         f"{', '.join(EM_MODES)} (the device EM is ROADMAP "
                         "B6/A11)")
    if (dist is not None and dist.n_proc > 1) or reads_sources:
        raise NotImplementedError(
            "the port's discover runs on one process: the distributed tail "
            "(dist, reads_sources) is not ported (ROADMAP B7/A12)")
    dev = require_cuda(device) if use_device else None

    out = pathlib.Path(outdir)
    out.mkdir(parents=True, exist_ok=True)
    tracer = Tracer(str(out), "metrics.discover.json")

    def _mark(stage):
        return tracer.mark(f"discover:{stage}")

    checks.check_spanning_file(spanning)
    params = EMParams(fragment_mean, fragment_stddev, precision,
                      min_cluster_size)
    have_native = native.available()

    # --- clustering -----------------------------------------------------
    clusters_path = out / "clusters"
    reads_handle = _reads_handle(out, fastq1, fastq2) if have_native \
        else None
    if em_mode in ("auto", "native") and have_native:
        # full native file->file driver: parse + bin + filter + EM + emit
        native.clustermatepairs(spanning, clusters_path, params)
    else:
        table = load_alignments(iter_compact(spanning))
        rows = cluster_alignments(table, params, use_device=use_device,
                                  em_mode=em_mode)
        write_clusters(rows, str(clusters_path))

    _mark("cluster")
    checks.check_clusters_file(str(clusters_path), min_cluster_size)
    ref_store = None
    if gene_models is not None:
        # mitochondrial segregation runs before setcover
        # (defuse_run.pl:466-468)
        from ..filters.cluster_filters import segregate_mitochondrial
        ref_store = FastaStore.from_file(reference)
        with open(clusters_path) as fh:
            lines = fh.readlines()
        lines = segregate_mitochondrial(lines, gene_models, mt_chromosome)
        clusters_path.write_text("".join(lines))

    _mark("segregate_mt")
    # --- set cover ------------------------------------------------------
    sc_path = out / "clusters.sc"
    run_setcover_file(str(clusters_path), str(sc_path), min_cluster_size)

    _mark("setcover")
    checks.check_setcover_file(str(clusters_path), str(sc_path))
    if gene_models is not None:
        from ..filters.cluster_filters import apply_post_setcover_filters
        with open(sc_path) as fh:
            lines = fh.readlines()
        lines = apply_post_setcover_filters(
            lines, gene_models, ref_store,
            seq_range=dna_concordant_length,
            min_cluster_size=min_cluster_size)
        sc_path.write_text("".join(lines))

    _mark("post_setcover_filters")
    # --- align regions --------------------------------------------------
    regions_path = out / "clusters.sc.regions"
    align_regions_file(sc_path, regions_path)

    _mark("regions")
    # --- split alignment ------------------------------------------------
    if ref_store is None:
        ref_store = FastaStore.from_file(reference)
    exon_regions = ExonRegions.from_file(exons)
    fusion_regions = read_align_region_pairs(str(regions_path))
    tasks = create_tasks(ref_store, exon_regions, fragment_mean,
                         fragment_stddev, min_read_length, max_read_length,
                         fusion_regions)
    realigner = SplitReadRealigner()
    for task in tasks.values():
        realigner.add_task(task)

    _mark("tasks_build")
    split_path = out / "splitreads.alignments"
    sorted_path = out / "splitreads.alignments.sorted"
    outs = {name: out / f"splitreads.{name}" for name in
            ("seq", "break", "predalign")}
    native_eval = False
    if have_native:
        # native driver: fastq + SAM parsing, candidate nomination,
        # realignment and row emission in C++; the device screen sits
        # between the two phases
        cluster_ids = sorted(tasks)
        flank1s = [tasks[cid].split_align_seq[0] for cid in cluster_ids]
        flank2s = [tasks[cid].split_align_seq[1] for cid in cluster_ids]
        driver = native.RealignDriver(
            improper, reads_handle if reads_handle is not None
            else (fastq1, fastq2), realigner.binned, cluster_ids,
            flank1s, flank2s)
        _mark("realign:driver_build")
        if os.environ.get("DEFUSE_STAGE_TIMING"):
            mx = max((max(len(a), len(b))
                      for a, b in zip(flank1s, flank2s)), default=0)
            print(f"[discover] candidates={driver.n_candidates} "
                  f"clusters={len(cluster_ids)} max_flank={mx}", flush=True)
        survivors = None
        if os.environ.get("DEFUSE_DEVICE_SCREEN", "auto") == "off":
            dev = None
        if dev is not None and driver.n_candidates and cluster_ids:
            survivors = _screen(driver, flank1s, flank2s, max_read_length,
                                dev, tracer, _mark)
        # full realign tail in C++ when possible: emit + sort + breakpoint
        # vote (byte-identical artifacts; falls back to the Python sort/
        # evaluate chain below on failure)
        native_eval = driver.emit_eval(
            tasks, cluster_ids, split_path, sorted_path, outs["seq"],
            outs["break"], outs["predalign"], survivors) is not None
        if not native_eval:
            driver.emit(split_path, survivors)
        _mark("realign:emit")
        driver.close()
    else:
        realigner.add_reads_fastq(fastq1)
        realigner.add_reads_fastq(fastq2)
        candidates = collect_candidates(realigner, iter_sam(improper))
        _mark("realign:collect")
        dp_dev = dev if dev is not None else torch.device("cpu")
        split_rows = realign_candidates(
            realigner, candidates, _rowmax_fn(dp_dev, tracer),
            device=dp_dev)
        with open(split_path, "w") as fh:
            for row in split_rows:
                fh.write(row.format() + "\n")
    if not native_eval:
        _mark("realign")
        # --- sort -n equivalent ----------------------------------------
        with open(split_path) as fh:
            lines = fh.readlines()
        lines.sort(key=lambda l: (int(l.split("\t", 1)[0]), l.encode()))
        with open(sorted_path, "w") as fh:
            fh.writelines(lines)
    _mark("sort")
    checks.check_split_alignments_sorted(str(sorted_path))
    if not native_eval:
        # --- evaluate --------------------------------------------------
        with open(outs["seq"], "w") as seq_out, \
                open(outs["break"], "w") as break_out, \
                open(outs["predalign"], "w") as pred_out:
            evaluate_file(tasks, str(sorted_path), seq_out, break_out,
                          pred_out)
    _mark("evaluate")
    tracer.flush()
    return {name: str(path) for name, path in outs.items()} | {
        "clusters": str(clusters_path), "clusters_sc": str(sc_path),
        "regions": str(regions_path), "split": str(split_path)}


def _rowmax_fn(dev, tracer):
    """The ``rowmax_fn`` of ``realign_candidates`` on ``dev``: numpy
    operands in, (2n, L+1) int32 row maxima out.  A CUDA device launches
    ``rowmax_kernel`` or raises; the CPU takes the plain version."""
    def rowmax_fn(refs_p, ref_lens, reads_p, read_lens):
        operands = tuple(
            torch.from_numpy(np.ascontiguousarray(a)).to(dev)
            for a in (refs_p, ref_lens, reads_p, read_lens))
        tracer.count("rowmax_instances", int(len(ref_lens)))
        tracer.counters["split_dp_impl"] = "cuda" if dev.type == "cuda" \
            else "torch"
        return dp_row_maxima_cuda(*operands).cpu().numpy()
    return rowmax_fn


def _reads_handle(out, fastq1, fastq2):
    """Native read store for the realign driver, picked as the reference
    picks it: the ``.fqi``-indexed store, else an eager parse in native
    threads."""
    handle = native.reads_index(fastq1, fastq2)
    if handle is None:
        # renamed fastqs without the sidecar index: build the offset index
        # with an IO-bound scan (candidates are <1% of fragments)
        fqi = out / "reads.fqi"
        try:
            fresh = fqi.exists() and fqi.stat().st_mtime >= max(
                os.stat(fastq1).st_mtime, os.stat(fastq2).st_mtime)
        except OSError:
            fresh = False
        if fresh or native.build_fqi(fastq1, fastq2, str(fqi)):
            handle = native.reads_index(fastq1, fastq2, str(fqi))
    if handle is None:
        handle = native.load_reads_async(fastq1, fastq2)
    return handle


def _screen(driver, flank1s, flank2s, max_read_length, dev, tracer, _mark):
    """The split-read DP screen on ``dev``: a bool mask of the candidate
    reads that some split alignment accepts."""
    L = _pad_len(max_read_length, 64)
    reads_p, read_lens, fidx = driver.read_matrix(L)
    _mark("screen:read_matrix")
    R = _pad_len(max(max(len(a), len(b)) for a, b in zip(flank1s, flank2s)))
    u1p, u1l = pad_batch(flank1s, R)
    u2rp, u2l = pad_batch([s[::-1] for s in flank2s], R)
    min_scores = screen_min_scores(read_lens)
    _mark("screen:pad")
    operands = screen_operands(u1p, u1l, u2rp, u2l, np.maximum(fidx, 0),
                               reads_p, read_lens, min_scores, dev)
    _mark("screen:upload")
    with device_trace("split_dp_screen"):
        max_scores = screen_candidates(*operands).cpu().numpy()
    tracer.count("screen_device_seconds", _mark("screen:device"))
    survivors = max_scores > 0
    tracer.count("screen_candidates", int(len(survivors)))
    tracer.count("screen_survivors", int(survivors.sum()))
    tracer.counters["split_dp_impl"] = "cuda" if dev.type == "cuda" \
        else "torch"
    return survivors
