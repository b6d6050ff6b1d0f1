"""Fusion discovery on the card: cluster -> set cover -> split align -> vote.

Counterpart of ``defuse_tpu/pipeline/discover.py``, with the same stages
and byte-identical artifacts, on both of its routes:

* with the native host library, clustering and realignment run in C++ and
  the one device stage is the split-read DP screen
  (``ops/split_dp_cuda.screen_candidates``), which drops the candidate
  reads no split alignment would accept; the native driver realigns the
  survivors;
* without it (``DEFUSE_NO_NATIVE=1`` or no compiler), clustering is the
  batched EM on the device (``cluster/matepair_em_batch``; the Python
  oracle with ``em_mode="oracle"`` or ``use_device=False``) and the
  realign is ``align/batch_realign``: DP row maxima from
  ``ops/split_dp_cuda.dp_row_maxima_cuda``, tie columns from
  ``ops/split_dp_cuda.dp_tie_columns_cuda``.

The device stages run as CUDA kernels (``device="cuda"``) or, only when
``device="cpu"`` is passed or ``use_device`` is false, as their plain
PyTorch versions on CPU tensors.

Whether the screen runs is the reference's decision:
``DEFUSE_DEVICE_SCREEN=force`` screens, ``off`` never does, and ``auto``
(the default) screens when ``pipeline.routing.screen_decision`` at the
card's link (``core.devices.link_profile``) puts the device side below the
native realign of the candidates.  The reference's wait for its device
probe, and the budget that bounds that wait, are not carried over: the port
has no probe, and a card that is absent raises at once.  The decision is
recorded as ``screen_route`` in ``metrics.discover.json``.
"""

from __future__ import annotations

import json
import os
import pathlib

import numpy as np
import torch

from ..align.batch_realign import (_pad_len, collect_candidates,
                                   realign_candidates)
from ..align.tasks import (SplitReadRealigner, create_tasks, evaluate_file,
                           read_align_region_pairs)
from ..cluster import matepair_em_batch, native
from ..cluster.discordant import cluster_alignments, write_clusters
from ..cluster.matepair_em import EMParams
from ..cluster.setcover import run_setcover_file
from ..convert import screen_min_scores, screen_operands
from ..core.devices import link_profile, require_cuda
from ..core.exons import ExonRegions
from ..io.fasta import FastaStore
from ..io.sam import iter_compact, iter_sam, load_alignments
from ..ops.split_dp_batch import pad_batch
from ..ops.split_dp_cuda import dp_row_maxima_cuda, screen_candidates
from ..parallel.shard import merge_cluster_parts
from ..utils import checks
from ..utils.profiling import Tracer, device_trace
from . import routing
from .regions import align_regions_file


EM_MODES = ("auto", "native", "oracle", "device")


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
    screen with the native library (where ``DEFUSE_DEVICE_SCREEN`` and the
    routing decision send it), the row maxima and tie columns of the
    Python realign without it.
    ``em_mode`` is "auto" (the native EM when the library is built; without
    it the batched EM on ``device`` with ``use_device``, else the oracle),
    "native", "oracle" (the Python EM, exact) or "device" (the batched EM
    on ``device``, decision-equivalent).  ``metrics.discover.json`` names
    the EM that ran as ``em_impl``: native, oracle, cuda, or torch where
    ``device="cpu"`` was passed.

    Distributed tail: with a ``dist`` (``parallel.launch.DistContext``) of
    more than one process, rank 0 publishes the clustering inputs, clusters
    its share of the bin pairs while ``cluster_partition_worker`` clusters
    the others' on their ranks, and merges the parts; both barriers run on
    every path.  ``reads_sources``, (fastq1, fastq2, frag_base) triples
    naming each rank's indexed shard store, lets the native realign driver
    read candidates through one grouped store.
    """
    if em_mode not in EM_MODES:
        raise ValueError(f"em_mode {em_mode!r}: the port runs "
                         f"{', '.join(EM_MODES)}")
    dev = require_cuda(device) if use_device or em_mode == "device" \
        else None

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
    reads_handle = _reads_handle(out, fastq1, fastq2, reads_sources) \
        if have_native else None
    native_cluster = em_mode in ("auto", "native") and have_native
    if dist is not None and dist.n_proc > 1:
        _cluster_rendezvous(dist, out, spanning, params, native_cluster,
                            clusters_path)
    elif native_cluster:
        # full native file->file driver: parse + bin + filter + EM + emit
        native.clustermatepairs(spanning, clusters_path, params)
    if native_cluster:
        tracer.counters["em_impl"] = "native"
    else:
        table = load_alignments(iter_compact(spanning))
        matepair_em_batch.LAST_SELECT_STATS.clear()
        matepair_em_batch.EM_RUN_STATS.clear()
        rows = cluster_alignments(table, params, use_device=use_device,
                                  em_mode=em_mode, device=device)
        write_clusters(rows, str(clusters_path))
        _record_em(tracer, em_mode, use_device, dev)

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
        if dev is not None and driver.n_candidates and cluster_ids:
            route = _screen_route(driver.n_candidates, max_read_length)
            tracer.counters["screen_route"] = route
            if route["choice"] == "device":
                survivors = _screen(driver, flank1s, flank2s,
                                    max_read_length, dev, tracer, _mark)
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


def _record_em(tracer, em_mode, use_device, dev):
    """Name the EM that ``cluster_alignments`` ran (its own rule for
    "auto" without the native library) and, for the batched EM, what its
    run and its selection counted."""
    if em_mode == "auto":
        em_mode = "device" if use_device else "oracle"
    if em_mode != "device":
        tracer.counters["em_impl"] = em_mode
        return
    tracer.counters["em_impl"] = "cuda" if dev.type == "cuda" else "torch"
    tracer.counters["em_select"] = dict(matepair_em_batch.LAST_SELECT_STATS)
    tracer.counters["em_run"] = dict(matepair_em_batch.EM_RUN_STATS)


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


def _cluster_rendezvous(dist, out, spanning, params, native_cluster,
                        clusters_path):
    """Rank 0's side of the distributed clustering
    (``defuse_run.pl:448-459`` fans clustering per chr-pair across jobs):
    every rank owns the bin pairs with canonical index = rank (mod n); rank
    0 publishes the exact inputs, clusters its share, and interleaves the
    parts back byte-identically.  The rendezvous (partmeta publish and both
    barriers) runs whenever a DistContext is live, also when this rank
    clusters locally (an em_mode or native-library disagreement), so the
    other ranks are never stranded in a barrier; the published ``mode``
    tells them which side they are on."""
    mode = "part" if native_cluster else "local"
    (out / "clusters.partmeta.json").write_text(json.dumps({
        "mode": mode,
        "frag_mean": float(params.fragment_mean).hex(),
        "frag_std": float(params.fragment_stddev).hex(),
        "precision": float(params.precision).hex(),
        "min_cluster_size": int(params.min_cluster_size),
        "spanning": str(spanning)}))
    dist.barrier("cluster_inputs")
    dist.cluster_inputs_done = True
    if native_cluster:
        native.clustermatepairs_part(
            spanning, out / "clusters.part0", out / "clusters.part0.counts",
            params, 0, dist.n_proc)
    dist.barrier("cluster_parts")
    dist.cluster_parts_done = True
    dist.cluster_rendezvous_done = True
    if native_cluster:
        merge_cluster_parts(
            [out / f"clusters.part{r}" for r in range(dist.n_proc)],
            [out / f"clusters.part{r}.counts" for r in range(dist.n_proc)],
            clusters_path)


def _reads_handle(out, fastq1, fastq2, reads_sources=None):
    """Native read store for the realign driver, picked as the reference
    picks it: the per-rank shard stores of ``reads_sources`` grouped by
    global fragment-id base, else the ``.fqi``-indexed store of the whole
    library, else an eager parse in native threads."""
    if reads_sources:
        # the per-rank frontends already indexed their own shards: group
        # those stores instead of building a whole-library index
        parts = [native.reads_index(f1, f2) for f1, f2, _b in reads_sources]
        if all(p is not None for p in parts):
            handle = native.reads_group(parts, [b for _f1, _f2, b in
                                                reads_sources])
            if handle is not None:
                return handle
        for p in parts:
            if p is not None:
                native.reads_free(p)
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


def _screen_route(n_candidates, max_read_length):
    """The screen's route, ``{"t_dev_s", "t_host_s", "choice", "mode"}``:
    the estimates of ``routing.screen_decision`` for ``n_candidates`` reads
    padded from ``max_read_length`` at the card's link on the native
    library's threads, the mode of ``DEFUSE_DEVICE_SCREEN`` and the route
    taken (``device`` or ``host``): the estimates' choice under ``auto``,
    ``device`` under ``force``, ``host`` under ``off``."""
    mode = os.environ.get("DEFUSE_DEVICE_SCREEN", "auto")
    link = link_profile()
    est = routing.screen_decision(n_candidates, _pad_len(max_read_length, 64),
                                  link, native._default_threads())
    choice = {"force": "device", "off": "host"}.get(mode, est["choice"])
    if os.environ.get("DEFUSE_STAGE_TIMING"):
        if mode == "force":
            print(f"[discover] screen: device (forced, B={n_candidates})",
                  flush=True)
        elif mode != "off":
            print(f"[discover] screen: {choice} wins (est dev "
                  f"{est['t_dev_s']:.4f}s vs host {est['t_host_s']:.4f}s, "
                  f"B={n_candidates}, link {link})", flush=True)
    return {**est, "choice": choice, "mode": mode}


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
