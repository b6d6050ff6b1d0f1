"""Top-level fusion discovery pipeline — the ``defuse_run.pl`` equivalent.

Stage graph (each stage checkpointed by the incremental Runner, so
reruns resume):

  align (or prealigned inputs)           [alignjob.pl]
  -> read stats + covariance samples     [read_stats.pl, calccov]
  -> discordant clustering               [clustermatepairs]
  -> set cover                           [setcover]
  -> split realignment (CUDA DP screen)  [dosplitalign]
  -> breakpoint vote                     [evalsplitalign]
  -> spanning/split p-values             [evaluate_*.R]
  -> annotation                          [annotate_fusions.pl]
  -> collate + classify + filter         [coallate_fusions.pl,
                                          run_adaboost.R, filter.pl]

The device stage runs on ``device`` ("cuda" unless the caller passes
"cpu", which takes the plain PyTorch versions); ``use_device=False`` keeps
the whole run on the host.  One process: a ``dist`` of more than one
raises (ROADMAP B7/A12).
"""

from __future__ import annotations

import pathlib

from ..annotate.adaboost import classify_results
from ..annotate.collate import collate, filter_by_probability
from ..annotate.features import Repeats, annotate_fusions
from ..annotate.gene_models import GeneModels
from ..annotate.mapping_stats import mapping_stats
from ..cluster.matepair_em import EMParams
from ..config import Config
from ..core.exons import ExonRegions
from ..io.fasta import FastaStore
from ..stats.calccov import calccov, write_samples
from ..stats.pvalues import spanning_pvalue, \
    split_pvalues
from ..stats.readstats import ReadStats, read_stats_from_sam
from ..core.devices import require_cuda
from .discover import discover_fusions
from .runner import Runner


def _notify_completion(config: Config, library_name: str,
                       status: str) -> None:
    """Completion/failure notification (``defuse_run.pl:188-216``):
    when the config carries a ``mailto`` value, pipe the status line to
    ``mail -s`` exactly as the reference does; failures to send are
    logged and swallowed (the analysis result must never depend on a
    mail transport)."""
    if config is None or not config.has_value("mailto"):
        return
    mailto = config.get_value("mailto")
    if not mailto:
        return
    import subprocess
    import time as _time
    text = (f"Fusion analysis of library {library_name} finished "
            f"with status {status}")
    stamp = _time.strftime("%Y-%m-%d %H:%M:%S")
    print(f"[{stamp}]  Attempting to mail {mailto} the result")
    try:
        subprocess.run(["mail", "-s", f"[AUTO] {text}", mailto],
                       input=text + "\n", text=True, timeout=60,
                       capture_output=True)
    except Exception as e:
        print(f"notification failed: {e}")


def run_pipeline(**kwargs):
    """``_run_pipeline`` plus the reference's completion/failure
    notification contract (see ``_notify_completion``).  The distributed
    tail is not ported (ROADMAP B7/A12): a ``dist`` of more than one
    process raises before anything runs, so the abort rendezvous below is
    kept as text and never reached."""
    status = "failure"
    dist = kwargs.get("dist")
    if dist is not None and getattr(dist, "n_proc", 1) > 1:
        raise NotImplementedError(
            "run_pipeline on more than one process is not ported "
            "(ROADMAP B7/A12): the collectives and parallel/launch.py wait")
    try:
        result = _run_pipeline(**kwargs)
        status = "success"
        return result
    except BaseException as e:
        if (dist is not None and getattr(dist, "n_proc", 1) > 1
                and not (getattr(dist, "cluster_rendezvous_done", False)
                         and getattr(dist, "cov_parts_done", True))):
            try:
                from ..parallel.launch import abort_cluster_partition
                abort_cluster_partition(dist, kwargs.get("output_dir"), e)
            except Exception as abort_err:
                print(f"distributed abort rendezvous failed: {abort_err}")
        raise
    finally:
        _notify_completion(kwargs.get("config"),
                           kwargs.get("library_name", ""), status)


def _run_pipeline(*, config: Config, output_dir: str, library_name: str,
                 spanning: str, improper: str, fastq1: str, fastq2: str,
                 concordant_sam: str | None = None,
                 pair_table=None,
                 reference_fasta: str | None = None,
                 cdna_regions: str | None = None,
                 gene_models_gtf: str | None = None,
                 genome_fasta: str | None = None,
                 repeats_regions: str | None = None,
                 expression: dict | None = None,
                 read_stats=None, reads_sources=None,
                 use_device: bool = True, target_indices=None,
                 dist=None, device="cuda"):
    """Run the post-alignment pipeline end to end.

    Alignment-stage inputs (spanning compact file, improper SAM,
    indexed fastqs, concordant cdna SAM) come either from the built-in
    aligner frontend (``defuse_tpu_torch.align.frontend``) or from any
    SAM-producing aligner.  ``pair_table`` is the frontend's optional
    binary twin of the concordant SAM (``cdna.pair.tbl``): when present
    the read-stats and calccov stages scan it instead of re-parsing the
    SAM text (outputs identical, pinned by tests).

    Distributed tail (multi-host): ``pair_table`` may be a LIST of
    per-rank part tables in rank order — the read-stats and calccov
    stages then never build (or scan) the multi-GB concatenated table:
    stats sums add exactly across parts, and each rank samples its own
    part with rank 0 merging the covariance parts in rank order
    (bit-identical to the single-table scan in both cases, pinned by
    tests/test_distributed_launch.py).  ``read_stats`` optionally
    passes the frontend's exact-sums allgather result so the stage
    skips its own scan (``allgather_read_stats_sums``).
    ``reads_sources`` — (fastq1, fastq2, frag_base) triples naming each
    rank's already-indexed shard store — lets the realign driver pread
    candidates through a grouped store instead of building a
    whole-library read index.
    """
    if use_device:
        # a run asked for the card fails here, not after the frontend
        require_cuda(device)
    out = pathlib.Path(output_dir)
    out.mkdir(parents=True, exist_ok=True)
    runner = Runner(str(out / "log"), "defuse-tpu")
    pair_tables = None
    if isinstance(pair_table, (list, tuple)):
        pair_tables = [str(p) for p in pair_table]
        missing = [p for p in pair_tables
                   if not pathlib.Path(p).exists()]
        if missing:
            raise FileNotFoundError(
                f"pair-table parts missing: {missing}")
    elif pair_table and not pathlib.Path(pair_table).exists():
        pair_table = None
    # stage-input declarations (mtime skip) for whichever table form
    _pt_inputs = pair_tables if pair_tables \
        else ([pair_table] if pair_table else [])

    reference_fasta = reference_fasta or config.get_value("reference_fasta")
    cdna_regions = cdna_regions or config.get_value("cdna_regions")

    def _pair_sam():
        """Path to the concordant pair SAM, materializing it from the
        binary pair table on first use when the frontend ran with the
        lazy checkpoint (pair_sam_checkpoint=lazy)."""
        nonlocal concordant_sam
        if concordant_sam:
            return concordant_sam
        if not pair_table:
            raise ValueError("no concordant pair SAM or pair table")
        if pair_tables:
            raise ValueError(
                "per-rank pair-table parts have no merged SAM; "
                "materialize one per part with pair_sam_from_tbl")
        from ..align.frontend import pair_sam_from_tbl
        prefix = str(fastq1)
        for suf in (".1.fastq", ".1.fq"):
            if prefix.endswith(suf):
                prefix = prefix[:-len(suf)]
                break
        concordant_sam = pair_sam_from_tbl(
            pair_table, prefix, out / "cdna.pair.sam.gz")
        return concordant_sam

    # --- read stats -----------------------------------------------------
    stats_path = out / "concordant.read.stats"

    def stage_read_stats(tmp_outputs):
        if read_stats is not None:
            # frontend's exact-sums allgather (bit-identical to the
            # whole-table scan: integer sums added in rank order plus
            # the same final formula — stats_from_sums)
            stats = read_stats
        elif concordant_sam or pair_table:
            from ..cluster import native
            stats = None
            if native.available():
                if pair_table:
                    stats = native.read_stats_tbl(pair_table)
                if stats is None and concordant_sam:
                    stats = native.read_stats_native(concordant_sam)
            if stats is None:
                from ..io.sam import open_text
                with open_text(_pair_sam()) as fh:
                    stats = read_stats_from_sam(fh)
        else:
            stats = ReadStats(0, config.get_float("fallback_frag_mean"),
                              config.get_float("fallback_frag_stddev"),
                              50, 50, (50,))
        with open(tmp_outputs[0], "w") as fh:
            fh.write(stats.format())

    runner.run("read stats", stage_read_stats,
               inputs=([concordant_sam] if concordant_sam else [])
               + _pt_inputs,
               outputs=[stats_path])
    stats = _read_stats_file(stats_path)

    frag_mean = stats.fraglength_mean
    frag_std = stats.fraglength_stddev
    params = EMParams(frag_mean, frag_std,
                      config.get_float("clustering_precision"),
                      config.get_int("span_count_threshold"))

    # --- covariance samples --------------------------------------------
    # ~30B/sample of text at scale: the native table path gzips the
    # artifacts (readers sniff magic, never the extension)
    from ..cluster import native as _native
    _cov_suffix = ".samples.gz" \
        if (_native.available() and pair_table) else ".samples"
    cov_paths = {n: out / f"cov.{n}{_cov_suffix}" for n in
                 ("span", "pos", "min")}
    # fused merge result (mean/cov per kind, hexfloat-exact): written
    # by the calccov stage so the pvalues stage skips re-parsing the
    # ~100MB-per-kind sample files; "insufficient" records the
    # reference's not-enough-samples abort for that kind
    cov_merged_path = out / "cov.merged.tsv"

    def _write_cov_merged(dst, merged):
        with open(dst, "w") as fh:
            for kind in ("span", "pos", "min"):
                mc = merged.get(kind)
                if mc is None:
                    fh.write(f"{kind}\tinsufficient\n")
                else:
                    fh.write(f"{kind}\t{mc[0].hex()}\t{mc[1].hex()}\n")

    # lazy samples: with the native table path the stage produces ONLY
    # the fused merge result — the ~30B/sample text artifacts (dead
    # weight since pvalues consumes cov.merged.tsv) are materialized on
    # demand via `export cov-samples` (the scan is deterministic)
    _lazy_cov = _native.available() and bool(pair_table)
    cov_dist = dist is not None and dist.n_proc > 1

    def _cov_publish(mode, extra=None):
        """Rank-0 side of the covariance rendezvous: publish the mode
        (+ exact sampling parameters in ``part`` mode) for
        ``tail_partition_worker``, then drain the inputs barrier."""
        import json as _json
        d = {"mode": mode}
        if extra:
            d.update(extra)
        (out / "cov.partmeta.json").write_text(_json.dumps(d))
        dist.barrier("cov_inputs")
        dist.cov_inputs_done = True

    def _cov_drain():
        dist.barrier("cov_parts")
        dist.cov_parts_done = True

    if (concordant_sam or pair_table) and cdna_regions:
        trim = config.get_int("discord_read_trim")
        anchor = config.get_int("split_min_anchor")
        density = config.get_float("covariance_sampling_density")
        multi = config.get_bool("multi_exon_transcripts_stats")
        cov_inputs = ([concordant_sam] if concordant_sam else []) \
            + [cdna_regions] + _pt_inputs
        cov_outputs = [cov_merged_path] if _lazy_cov else \
            [cov_paths["span"], cov_paths["pos"], cov_paths["min"],
             cov_merged_path]
        cov_part_mode = False
        if cov_dist:
            # the rendezvous must run exactly once per rank whatever
            # the stage decides, so the mode is published from the same
            # up-to-date check the runner will apply
            will_run = not Runner._uptodate(cov_inputs, cov_outputs)
            cov_part_mode = bool(will_run and _native.available()
                                 and pair_tables
                                 and len(pair_tables) == dist.n_proc)
            if cov_part_mode:
                # stale kind deliveries from a previous run must never
                # satisfy this run's poll (publish precedes all worker
                # activity, so no worker is writing yet)
                for k in (1, 2):
                    (out / f"cov.kind{k}.merged.tsv").unlink(
                        missing_ok=True)
                _cov_publish("part", {
                    "cdna_regions": str(cdna_regions),
                    "trim": int(trim), "anchor": int(anchor),
                    "density": float(density).hex(),
                    "multi": bool(multi)})
            else:
                _cov_publish("skip")
                _cov_drain()

        def stage_calccov(tmp_outputs):
            er = ExonRegions.from_file(cdna_regions)
            # native sampling pass (byte-identical; the glibc marker
            # stream stays in Python, the hot SAM scan runs in C++)
            from ..cluster import native
            from ..stats.calccov import sample_positions

            merged_dst = tmp_outputs[0] if _lazy_cov else tmp_outputs[3]

            def _merge_files(paths):
                """Derive the merged artifact from just-written sample
                files (bit-identical source)."""
                from ..stats.pvalues import (cov_samples_merge_arrays,
                                             load_cov_samples)
                merged = {}
                for kind, p in zip(("span", "pos", "min"), paths):
                    try:
                        mc = native.cov_merge_file(p) \
                            if native.available() else None
                        if mc is None:
                            mc = cov_samples_merge_arrays(
                                *load_cov_samples(p))
                        merged[kind] = mc
                    except ValueError:
                        merged[kind] = None
                _write_cov_merged(merged_dst, merged)

            names = positions = None
            if native.available():
                ref_index, positions = sample_positions(er, density,
                                                        multi)
                names = [""] * len(ref_index)
                for tid, idx in ref_index.items():
                    names[idx] = tid
                mref = [r for r, _p in positions]
                mpos = [p for _r, p in positions]
                if pair_tables:
                    # per-part sampling: rank r's part scanned by rank
                    # r (part mode) or all parts sequentially here
                    # (single-process list form); the parts merge in
                    # rank order — bit-identical to one scan of the
                    # concatenated table (same sample sequence, same
                    # drand48 stream)
                    my = [0] if cov_part_mode else \
                        range(len(pair_tables))
                    ok = True
                    for r in my:
                        rc = native.calccov_tbl(
                            pair_tables[r], names, mref, mpos,
                            trim_length=trim, anchor=anchor,
                            span_path=None, pos_path=None,
                            min_path=None,
                            bin_path=out / f"cov.part{r}.covbin")
                        ok = ok and rc is not None
                    if cov_part_mode:
                        _cov_drain()  # workers' parts are now on disk
                    if not ok:
                        raise RuntimeError(
                            "native covariance part scan failed")
                    parts = [out / f"cov.part{r}.covbin"
                             for r in range(len(pair_tables))]
                    if cov_part_mode and dist.n_proc > 1:
                        # the three kind merges are independent: kinds
                        # 1/2 are delegated to ranks 1/2 (file handoff
                        # after the cov_parts barrier — no extra
                        # collectives), rank 0 merges the rest and
                        # falls back to any kind a worker failed to
                        # deliver.  Each entry is bit-identical to the
                        # full merge's.
                        def _kind_local(k):
                            # (mean, cov) | None=insufficient; raises
                            # on IO failure (None return from native)
                            try:
                                mc = native.cov_merge_bin_kind(parts, k)
                            except ValueError:
                                return None  # count<=100 contract
                            if mc is None:
                                raise RuntimeError(
                                    f"covariance kind-{k} merge failed")
                            return mc

                        delegated = [k for k in (1, 2)
                                     if k < dist.n_proc]
                        own = [k for k in range(3)
                               if k not in delegated]
                        merged = {}
                        if len(own) > 1:
                            # ctypes releases the GIL: own kinds merge
                            # concurrently on whatever cores this rank
                            # has (matters at n_proc=2, where kinds 0
                            # and 2 both stay on rank 0)
                            import concurrent.futures as _cf
                            with _cf.ThreadPoolExecutor(len(own)) as px:
                                for k, mc in zip(own, px.map(
                                        _kind_local, own)):
                                    merged[native.COV_KINDS[k]] = mc
                        else:
                            for k in own:
                                merged[native.COV_KINDS[k]] = \
                                    _kind_local(k)
                        import time as _t
                        deadline = _t.time() + 120.0
                        for k in delegated:
                            kf = out / f"cov.kind{k}.merged.tsv"
                            mc = False  # sentinel: not delivered
                            while _t.time() < deadline:
                                try:
                                    txt = kf.read_text().strip()
                                except OSError:
                                    _t.sleep(0.05)
                                    continue
                                if txt == "insufficient":
                                    mc = None
                                else:
                                    f = txt.split("\t")
                                    mc = (float.fromhex(f[0]),
                                          float.fromhex(f[1]))
                                break
                            if mc is False:
                                mc = _kind_local(k)  # worker fallback
                            merged[native.COV_KINDS[k]] = mc
                    else:
                        merged = native.cov_merge_bin(parts)
                        if merged is None:
                            raise RuntimeError(
                                "covariance part merge failed (parts: "
                                f"{[str(p) for p in parts]})")
                    _write_cov_merged(merged_dst, merged)
                    for p in parts:
                        p.unlink(missing_ok=True)
                    for k in (1, 2):
                        (out / f"cov.kind{k}.merged.tsv").unlink(
                            missing_ok=True)
                    return
                if pair_table:
                    rc = native.calccov_tbl(
                        pair_table, names, mref, mpos,
                        trim_length=trim, anchor=anchor,
                        span_path=None if _lazy_cov else tmp_outputs[0],
                        pos_path=None if _lazy_cov else tmp_outputs[1],
                        min_path=None if _lazy_cov else tmp_outputs[2],
                        merge_seed=11)
                    if rc is not None:
                        _write_cov_merged(merged_dst, rc[1])
                        return
            # fallback paths must produce the sample files; under the
            # lazy stage shape they land beside the run as side
            # artifacts (tmp + rename)
            if _lazy_cov:
                sample_dsts = [str(cov_paths[n]) for n in
                               ("span", "pos", "min")]
                sample_tmps = [d + ".stagetmp" +
                               (".gz" if d.endswith(".gz") else "")
                               for d in sample_dsts]
            else:
                sample_dsts = sample_tmps = [tmp_outputs[0],
                                             tmp_outputs[1],
                                             tmp_outputs[2]]
            done = False
            if native.available():
                done = native.calccov_native(
                    _pair_sam(), names,
                    [r for r, _p in positions],
                    [p for _r, p in positions],
                    trim_length=trim, anchor=anchor,
                    span_path=sample_tmps[0],
                    pos_path=sample_tmps[1],
                    min_path=sample_tmps[2]) is not None
            if not done:
                span, spos, smin = calccov(
                    _pair_sam(), er, trim_length=trim,
                    split_min_anchor=anchor, density=density,
                    multi_exon=multi)
                write_samples(span, sample_tmps[0], float_values=False)
                write_samples(spos, sample_tmps[1], float_values=True)
                write_samples(smin, sample_tmps[2], float_values=True)
            if _lazy_cov:
                import os as _os
                for t, d in zip(sample_tmps, sample_dsts):
                    _os.replace(t, d)
            _merge_files(sample_dsts)

        try:
            runner.run("covariance samples", stage_calccov,
                       inputs=cov_inputs, outputs=cov_outputs)
        finally:
            if cov_part_mode and not dist.cov_parts_done:
                # the stage raced to up-to-date (or failed before its
                # own drain): release the workers regardless
                _cov_drain()
    elif cov_dist:
        # no covariance stage in this configuration — the workers
        # still rendezvous, so publish a skip and drain both barriers
        _cov_publish("skip")
        _cov_drain()
    # read-stats and calccov shared one native table load; release the
    # multi-GB cache now that the scans are done
    if _native.available():
        _native.pairtbl_cache_clear()

    from ..utils.profiling import Tracer
    _tracer = Tracer(str(out))
    _mark = _tracer.mark

    # --- cluster + split chain -----------------------------------------
    gm = GeneModels(gene_models_gtf) if gene_models_gtf else None
    discover_outs = discover_fusions(
        spanning=spanning, improper=improper, fastq1=fastq1,
        fastq2=fastq2, reference=reference_fasta, exons=cdna_regions,
        fragment_mean=frag_mean, fragment_stddev=frag_std,
        precision=config.get_float("clustering_precision"),
        min_cluster_size=config.get_int("span_count_threshold"),
        min_read_length=stats.readlength_min,
        max_read_length=stats.readlength_max,
        outdir=str(out), use_device=use_device,
        gene_models=gm,
        mt_chromosome=config.get_value("mt_chromosome"),
        dna_concordant_length=config.get_int("dna_concordant_length"),
        dist=dist, reads_sources=reads_sources, device=device)

    _mark("discover")
    # --- p-values -------------------------------------------------------
    # preferred source: the calccov stage's fused merge artifact
    # (hexfloat-exact, bit-identical to re-merging the sample files);
    # otherwise the three sample files merge independently — the native
    # merge releases the GIL, so a thread per file runs them
    # concurrently
    covariances = {}
    premerged = {}
    if cov_merged_path.exists():
        for line in open(cov_merged_path):
            f = line.rstrip("\n").split("\t")
            if len(f) == 3:
                premerged[f[0]] = (float.fromhex(f[1]),
                                   float.fromhex(f[2]))
            elif len(f) == 2 and f[1] == "insufficient":
                premerged[f[0]] = "insufficient"

    def _merge_one(path):
        from ..cluster import native
        from ..stats.pvalues import (cov_samples_merge_arrays,
                                     load_cov_samples)
        merged = native.cov_merge_file(path) \
            if native.available() else None
        if merged is None:
            merged = cov_samples_merge_arrays(*load_cov_samples(path))
        return merged[1]

    from concurrent.futures import ThreadPoolExecutor
    with ThreadPoolExecutor(max_workers=3) as _pool:
        futures = {n: _pool.submit(_merge_one, cov_paths[n])
                   for n in ("span", "pos", "min")
                   if n not in premerged and cov_paths[n].exists()}
    for n in ("span", "pos", "min"):
        path = cov_paths[n]
        if n in premerged:
            if premerged[n] == "insufficient":
                import sys as _sys
                print(f"WARNING: {n} covariance merge failed (not "
                      "enough concordant read samples; set "
                      "multi_exon_transcripts_stats = yes); "
                      "falling back to covariance 0.0 — p-values will "
                      "deviate from a full-size run. Check that "
                      "multi_exon_transcripts covered enough concordant "
                      "pairs (reference aborts here).",
                      file=_sys.stderr)
                covariances[n] = 0.0
            else:
                covariances[n] = premerged[n][1]
            continue
        if path.exists():
            try:
                covariances[n] = futures[n].result()
            except ValueError as e:
                # The reference hard-aborts here (merge_cov_samples.pl:38
                # "not enough concordant read samples").  We degrade to
                # covariance 0.0 so tiny test datasets still run, but
                # loudly: every spanning/split p-value shifts when the
                # covariance term is dropped.
                import sys as _sys
                print(f"WARNING: {n} covariance merge failed ({e}); "
                      "falling back to covariance 0.0 — p-values will "
                      "deviate from a full-size run. Check that "
                      "multi_exon_transcripts covered enough concordant "
                      "pairs (reference aborts here).",
                      file=_sys.stderr)
                covariances[n] = 0.0
        else:
            covariances[n] = 0.0

    seqs = {}
    split_p = {}
    span_p = {}
    for line in open(discover_outs["seq"]):
        f = line.rstrip("\n").split("\t")
        cid = int(f[0])
        seqs[cid] = (f[1], int(f[3]))
        pos_avg, min_avg = float(f[4]), float(f[5])
        count = int(f[3])
        pp, mp = split_pvalues(pos_avg, min_avg, count,
                               covariances["pos"], covariances["min"])
        split_p[cid] = (f"{pp:.15g}", f"{mp:.15g}")

    span_stats = _span_stats(out / "clusters.sc", discover_outs["break"],
                             discover_outs["seq"])
    # evaluate_fraglength_mean.R clamps the read length by the discordant
    # trim (defuse_run.pl:557 passes $discord_read_trim; the R script takes
    # min(readlength_max, trim)) — reads longer than the trim must not
    # trigger the fat-fragment correction branch spuriously.
    span_readlen = min(stats.readlength_max,
                       config.get_int("discord_read_trim"))
    for cid in seqs:
        mean, n = span_stats.get(cid, (frag_mean, 1))
        sp = spanning_pvalue(mean, n, frag_mean, frag_std,
                             covariances["span"], span_readlen)
        span_p[cid] = f"{sp:.15g}"

    _mark("pvalues")
    # --- breakpoint sequence alignment (gmap/blat stage) ----------------
    psl_paths: dict[str, str] = {}
    if genome_fasta:
        from ..align.breakseq import align_breakpoints
        from ..align.seedindex import SeedIndex

        breakseqs = {}
        for line in open(discover_outs["seq"]):
            f = line.rstrip("\n").split("\t")
            if f[1] not in ("N", ""):
                breakseqs[int(f[0])] = f[1]
        targets = dict(target_indices or {})
        if "genome" not in targets:
            # mmap-load the persisted index (bowtie-build semantics)
            # instead of rebuilding the multi-GB genome index per run —
            # the build dominated the whole breakseq stage (~10s at 10M
            # pairs); content is identical (load_or_build stamps and
            # validates the fasta source).  create-ref persists one
            # under dataset_prefix; otherwise it lands beside the fasta.
            genome_prefix = None
            if config.has_value("dataset_prefix"):
                genome_prefix = config.get_value("dataset_prefix") \
                    + ".genome.seedidx"
                if not SeedIndex.saved_exists(genome_prefix):
                    genome_prefix = None
            targets["genome"] = SeedIndex.load_or_build(
                genome_fasta, prefix=genome_prefix)
        for tname, key in (("cdna", "cdna_fasta"),
                           ("exons", "exons_fasta"),
                           ("cds", "cds_fasta"), ("est", "est_fasta")):
            if tname not in targets and config.has_value(key):
                path = config.get_value(key)
                import os as _os
                if _os.path.exists(path):
                    targets[tname] = SeedIndex.load_or_build(path)
        psl_paths = align_breakpoints(breakseqs, targets, str(out))

    _mark("breakseq")
    # --- annotation -----------------------------------------------------
    annotations: dict[int, dict] = {}
    # the classifier needs the full feature set; denovo-only annotation
    # keys (injected below) must not trigger it on their own
    full_annotation = gm is not None and genome_fasta
    if gm is not None and genome_fasta:
        genome = FastaStore.from_file(genome_fasta)
        repeats = Repeats(repeats_regions)
        breaks = {}
        for line in open(discover_outs["break"]):
            f = line.rstrip("\n").split("\t")
            breaks.setdefault(int(f[0]), {})[int(f[1])] = (f[2], f[3],
                                                           int(f[4]))
        clusters: dict = {}
        solution: dict = {}
        for line in open(out / "clusters.sc"):
            f = line.rstrip("\n").split("\t")
            cid, cend, frag = int(f[0]), int(f[1]), int(f[2])
            clusters.setdefault(cid, {}).setdefault(cend, {})[frag] = (
                int(f[6]), int(f[7]))
            solution[frag] = cid
        spanning_rows = []
        for line in open(spanning):
            f = line.rstrip("\n").split("\t")
            spanning_rows.append((int(f[0]), int(f[1]), f[2], f[3],
                                  int(f[4]), int(f[5])))
        mstats = mapping_stats(spanning_rows, solution, gm)
        extra_kwargs = {}
        if config.get_bool("calculate_extra_annotations") \
                and (concordant_sam or pair_table):
            from ..annotate.extra import (break_concordant,
                                          index_sam_by_ref,
                                          index_tbl_by_ref, interrupted,
                                          interrupted_index,
                                          splicing_index)
            from ..parallel.shard import pair_table_has_strand
            if pair_table and pair_table_has_strand(
                    pair_tables[0] if pair_tables else pair_table):
                by_ref = index_tbl_by_ref(pair_table)
            else:
                # v1 table (no strand bit) or no table: the SAM is the
                # only strand-bearing source
                from ..io.sam import open_text
                with open_text(_pair_sam()) as fh:
                    by_ref = index_sam_by_ref(fh)
            max_frag = int(frag_mean + 3 * frag_std)
            bias = config.get_int("splice_bias")
            bc = break_concordant(breaks, gm, by_ref, max_frag, bias)
            info = interrupted(breaks, gm, by_ref, bias)
            span_counts = {c: len(next(iter(ends.values())))
                           for c, ends in clusters.items()}
            extra_kwargs["splicing_index"] = splicing_index(bc,
                                                            span_counts)
            extra_kwargs["interrupted_index"] = interrupted_index(info)

        rows = annotate_fusions(
            breaks=breaks, seqs={c: s for c, (s, _n) in seqs.items()},
            clusters=clusters, gene_models=gm, genome=genome,
            repeats=repeats, expression=expression or {},
            read_stats=stats, library_name=library_name,
            mapping_stats=mstats,
            psl_genome=psl_paths.get("genome"),
            psl_genome_nointron=psl_paths.get("genome.nointron"),
            psl_cdna=psl_paths.get("cdna"),
            psl_est=psl_paths.get("est"),
            psl_exons=psl_paths.get("exons"),
            psl_cds=psl_paths.get("cds"),
            est_alignments=config.get_value("est_alignments")
            if config.has_value("est_alignments") else None,
            percident_threshold=config.get_float(
                "percent_identity_threshold"),
            **extra_kwargs)
        with open(out / "annotations", "w") as fh:
            for r in rows:
                fh.write(r + "\n")
        for r in rows:
            cid_s, key, value = r.split("\t", 2)
            annotations.setdefault(int(cid_s), {})[key] = value

    _mark("annotation")
    # --- optional de novo assembly (separate outputs; results.tsv keeps
    # reference-schema parity) ------------------------------------------
    denovo_outs = {}
    if config.get_bool("denovo_assembly"):
        from ..align.tasks import SplitReadRealigner
        from ..cluster import native as native_lib
        from .denovo_stage import assemble_clusters, write_denovo_outputs

        dn_realigner = SplitReadRealigner()
        # reuse the split tasks' binned mate regions for nomination
        from ..align.tasks import create_tasks as _create_tasks
        from ..align.tasks import read_align_region_pairs as _rarp
        dn_tasks = _create_tasks(
            FastaStore.from_file(reference_fasta),
            ExonRegions.from_file(cdna_regions), frag_mean, frag_std,
            stats.readlength_min, stats.readlength_max,
            _rarp(discover_outs["regions"]))
        for task in dn_tasks.values():
            dn_realigner.add_task(task)
        dn_realigner.add_reads_fastq(fastq1)
        dn_realigner.add_reads_fastq(fastq2)
        if native_lib.available():
            cand_rows = native_lib.collect_candidates(
                improper, dn_realigner.binned).tolist()
        else:
            from ..align.batch_realign import collect_candidates as _cc
            from ..io.sam import iter_sam as _isam
            cand_rows = [(c.cluster_id, c.fragment, c.read_end,
                          c.rev_comp) for c in _cc(dn_realigner,
                                                   _isam(improper))]

        def _lookup(fragment, read_end):
            return dn_realigner.reads.get(fragment | (read_end << 31), "")

        assemblies = assemble_clusters(cand_rows, _lookup)
        # real denovo spanning p-values: locate each assembly's junction
        # against its flank pair, convert to reference breakpoints
        # (evaluate's coordinate rules), run the calc_span_stats math
        from .denovo_stage import (denovo_annotation_rows,
                                   denovo_break_positions, infer_junction)
        dn_breaks: dict[int, dict[int, int]] = {}
        for cid in assemblies:
            task = dn_tasks.get(cid)
            if task is None:
                continue
            j = infer_junction(task, assemblies[cid][0])
            if j is not None:
                dn_breaks[cid] = denovo_break_positions(task, *j)
        dn_stats = _span_stats_from_breaks(
            out / "clusters.sc", dn_breaks, {cid: 0 for cid in dn_breaks})
        dn_span_p = {
            cid: (spanning_pvalue(mean, n, frag_mean, frag_std,
                                  covariances["span"], span_readlen), n)
            for cid, (mean, n) in dn_stats.items()}
        verdict, denovo_outs = write_denovo_outputs(
            assemblies, {cid: float(p) for cid, p in span_p.items()},
            dn_span_p, str(out))
        # surface the documented break_predict / denovo_* columns
        # (README.md:276-287) into results.tsv via the annotations join
        dn_rows = denovo_annotation_rows(
            sorted(set(seqs) | set(assemblies)), assemblies, dn_span_p,
            verdict)
        anno_path = out / "annotations"
        with open(anno_path, "a" if anno_path.exists() else "w") as fh:
            for cid in sorted(dn_rows):
                for key in sorted(dn_rows[cid]):
                    fh.write(f"{cid}\t{key}\t{dn_rows[cid][key]}\n")
                annotations.setdefault(cid, {}).update(dn_rows[cid])
    _mark("denovo")

    # --- collate + classify + filter -----------------------------------
    results = out / "results.tsv"
    with open(results, "w") as fh:
        collate(sorted(annotations or seqs), seqs, span_p, split_p,
                annotations, fh)
    classified = out / "results.classify.tsv"
    filtered = out / "results.filtered.tsv"
    if full_annotation and annotations:
        margin_seeds = (config.get_int("report_margin_seeds")
                        if config.has_value("report_margin_seeds") else 0)
        classify_results(str(results), str(classified),
                         margin_seeds=margin_seeds)
        filter_by_probability(str(classified), str(filtered),
                              config.get_float("probability_threshold"))
    else:
        # never serve stale classifier outputs from a previous run in
        # the same output directory
        for p in (classified, filtered):
            if p.exists():
                p.unlink()
    _mark("collate+classify")
    _tracer.flush()
    return {"results": str(results),
            "classified": str(classified) if classified.exists()
            else None,
            "filtered": str(filtered) if filtered.exists() else None,
            **denovo_outs}


def _read_stats_file(path) -> ReadStats:
    with open(path) as fh:
        keys = fh.readline().rstrip("\n").split("\t")
        values = fh.readline().rstrip("\n").split("\t")
    d = dict(zip(keys, values))
    return ReadStats(int(d["frag_count"]), float(d["fraglength_mean"]),
                     float(d["fraglength_stddev"]),
                     int(d["readlength_min"]), int(d["readlength_max"]))


def _span_stats(clusters_sc_path, breaks_path, seq_path):
    """Per-cluster spanning fragment-length mean/count relative to the
    predicted breakpoint (``scripts/calc_span_stats.pl``): per fragment,
    sum over ends of (breakpos - start + 1) on '+' or (end - breakpos + 1)
    on '-', plus the inter-sequence length from the seq file."""
    break_pos: dict = {}
    for line in open(breaks_path):
        f = line.rstrip("\n").split("\t")
        break_pos.setdefault(int(f[0]), {})[int(f[1])] = int(f[4])
    inter_length: dict[int, int] = {}
    for line in open(seq_path):
        f = line.rstrip("\n").split("\t")
        inter_length[int(f[0])] = int(f[2])
    return _span_stats_from_breaks(clusters_sc_path, break_pos,
                                   inter_length)


def _span_stats_from_breaks(clusters_sc_path, break_pos, inter_length):
    """calc_span_stats core against caller-supplied break positions
    ({cid: {end: pos}}) — shared by the splitr flow and the denovo
    arbitration (which derives its breakpos from the assembly)."""
    strand_by_end: dict = {}
    extents: dict = {}
    for line in open(clusters_sc_path):
        f = line.rstrip("\n").split("\t")
        cid, cend, frag = int(f[0]), int(f[1]), int(f[2])
        strand_by_end[(cid, cend)] = f[5]
        extents.setdefault(cid, {}).setdefault(frag, {})[cend] = (
            int(f[6]), int(f[7]))

    out: dict[int, tuple[float, int]] = {}
    for cid, frags in extents.items():
        if cid not in break_pos:
            continue
        total = 0.0
        count = 0
        for frag, ends in frags.items():
            length = 0
            for cend, (start, end) in ends.items():
                bp = break_pos[cid][cend]
                if strand_by_end[(cid, cend)] == "+":
                    length += bp - start + 1
                else:
                    length += end - bp + 1
            length += inter_length[cid]
            total += length
            count += 1
        out[cid] = (total / count, count)
    return out


def materialize_cov_samples(config: Config, run_dir, out_dir):
    """Materialize the covariance sample text artifacts on demand
    (lazy-samples runs emit only ``cov.merged.tsv``; the sampling scan
    is deterministic, so re-running it with output paths reproduces the
    exact bytes an eager run would have written).  Returns
    {kind: path}.

    NOTE: this mirrors ``stage_calccov``'s sample-production chain
    (sample_positions -> native tbl -> native SAM -> python); any
    change to either side must keep them in lockstep —
    tests/test_pipeline_sharded.py pins materialized == eager bytes."""
    import os

    run_dir = pathlib.Path(run_dir)
    out = pathlib.Path(out_dir)
    out.mkdir(parents=True, exist_ok=True)
    cdna_regions = config.get_value("cdna_regions")
    er = ExonRegions.from_file(cdna_regions)
    trim = config.get_int("discord_read_trim")
    anchor = config.get_int("split_min_anchor")
    density = config.get_float("covariance_sampling_density")
    multi = config.get_bool("multi_exon_transcripts_stats")
    from ..cluster import native
    from ..stats.calccov import sample_positions

    tbl = next((run_dir / t for t in
                ("cdna.pair.tbl", "aligned/cdna.pair.tbl")
                if (run_dir / t).exists()), None)
    suffix = ".samples.gz" if (native.available() and tbl) else ".samples"
    paths = {n: out / f"cov.{n}{suffix}" for n in ("span", "pos", "min")}
    tmps = [str(p) + ".tmp" + (".gz" if suffix.endswith(".gz") else "")
            for p in paths.values()]
    if native.available() and tbl:
        ref_index, positions = sample_positions(er, density, multi)
        names = [""] * len(ref_index)
        for tid, idx in ref_index.items():
            names[idx] = tid
        rc = native.calccov_tbl(
            tbl, names, [r for r, _p in positions],
            [p for _r, p in positions], trim_length=trim, anchor=anchor,
            span_path=tmps[0], pos_path=tmps[1], min_path=tmps[2])
        if rc is not None:
            for t, d in zip(tmps, paths.values()):
                os.replace(t, d)
            return {n: str(p) for n, p in paths.items()}
    # SAM-scan fallback (eager runs / no native lib)
    sam = next((run_dir / s for s in
                ("cdna.pair.sam.gz", "cdna.pair.sam",
                 "aligned/cdna.pair.sam.gz", "aligned/cdna.pair.sam")
                if (run_dir / s).exists()), None)
    if sam is None:
        raise FileNotFoundError(
            f"no cdna.pair.tbl or cdna.pair.sam under {run_dir}")
    span, spos, smin = calccov(str(sam), er, trim_length=trim,
                               split_min_anchor=anchor, density=density,
                               multi_exon=multi)
    write_samples(span, tmps[0], float_values=False)
    write_samples(spos, tmps[1], float_values=True)
    write_samples(smin, tmps[2], float_values=True)
    for t, d in zip(tmps, paths.values()):
        os.replace(t, d)
    return {n: str(p) for n, p in paths.items()}
