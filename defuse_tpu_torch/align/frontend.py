"""The aligner frontend on the card: fastqs to the clustering inputs.

Counterpart of ``defuse_tpu/align/frontend.py::align_reads``, the CLI
helper that builds the seed indices from the config's references and runs
``align_job`` (the ``alignjob.pl`` equivalent).  Everything but the verify
wiring is the shared host layer of ``defuse_tpu``: fastq ingest, the seed
indices, ``align_job`` with its native C++ driver and its Python path.
The one device stage is candidate verification, which runs as the CUDA
kernel of ``ops/verify_cuda.py`` through ``ops.verify_batch.DeviceVerifier``
when it is engaged.
"""

from __future__ import annotations

import os
import pathlib
import time

from defuse_tpu.align.frontend import align_job, index_paired_fastq
from defuse_tpu.align.seedindex import SeedIndex
from defuse_tpu.annotate.gene_models import GeneModels
from defuse_tpu.cluster import native
from defuse_tpu.io.fasta import FastaStore

from ..core.devices import require_cuda
from ..ops.verify_batch import DeviceVerifier


def align_reads(config, output_dir, fastq1, fastq2, use_device=True,
                frag_base=0, device="cuda"):
    """Build indices from config-named references and run the frontend;
    returns run_pipeline keyword inputs.

    Routing is the reference's: with ``DEFUSE_DEVICE_VERIFY=auto`` (the
    default) the native fused C++ seed+verify runs when the native library
    is present, and ``DeviceVerifier(device)`` verifies the candidates of
    the Python seed path when it is absent; ``force`` verifies on
    ``device`` regardless; ``off`` or ``use_device=False`` never does.
    ``device="cuda"`` without CUDA raises.  ``frag_base`` offsets fragment
    ids globally when this process owns one shard of a multi-process run.
    """
    dev = require_cuda(device) if use_device else None
    tv = [time.time()]

    def _tmark(label):
        if os.environ.get("DEFUSE_ALIGNJOB_TIMING"):
            now = time.time()
            print(f"[align_reads] {label}: {now - tv[0]:.2f}s", flush=True)
            tv[0] = now

    out = pathlib.Path(output_dir)
    ingested = native.ingest_fastq(fastq1, fastq2, str(out / "reads")) \
        if native.available() else None
    _tmark("fastq ingest")
    if ingested is not None:
        # native ingest: renamed fastqs + .fqi + names written in C++,
        # reads handed to the aligner as char matrices
        reads1, reads2 = ingested
    else:
        reads1, reads2, _names = index_paired_fastq(fastq1, fastq2,
                                                    str(out / "reads"))
    gene_models = GeneModels(config.get_value("gene_models"))

    # short-read libraries (< 3*16bp after trim): for references small
    # enough to rebuild quickly, re-index at k = read_len//3 so the full
    # 2-mismatch pigeonhole guarantee holds; huge references keep the
    # persisted k=16 index with staggered seeds
    if isinstance(reads1, tuple):
        lmax = int(max(reads1[1].max() if len(reads1[1]) else 0,
                       reads2[1].max() if len(reads2[1]) else 0))
    else:
        lmax = max((len(r) for r in list(reads1) + list(reads2)),
                   default=0)
    trim = config.get_int("discord_read_trim")
    eff_len = min(lmax, trim) if lmax else trim
    short_k = None
    if 0 < eff_len < 48:
        genome_bp = 0
        try:
            genome_bp = os.path.getsize(config.get_value("genome_fasta"))
        except OSError:
            pass
        if genome_bp <= 512_000_000:
            short_k = max(8, eff_len // 3)
            print(f"short-read library (<=~{eff_len}bp): rebuilding "
                  f"seed indices at k={short_k} for full 2-mismatch "
                  "sensitivity", flush=True)

    def index_of(key, prefix=None):
        if short_k is not None:
            return SeedIndex(
                FastaStore.from_file(config.get_value(key))._seqs,
                seed_len=short_k)
        return SeedIndex.load_or_build(config.get_value(key), prefix=prefix)

    cdna_index = index_of("cdna_fasta")
    genome_prefix = None
    if short_k is None and config.has_value("dataset_prefix"):
        genome_prefix = config.get_value("dataset_prefix") + ".genome.seedidx"
        if not SeedIndex.saved_exists(genome_prefix):
            genome_prefix = None
    genome_index = index_of("genome_fasta", genome_prefix)
    rrna_index = index_of("rrna_fasta") if config.has_value("rrna_fasta") \
        else None
    # unigene prefilter fastas (config `prefilter1..N`); multiple fastas
    # merge into one index: the screen only asks whether a proper pair
    # exists on any single prefilter sequence
    prefilter_index = None
    prefilter_paths = [p for p in config.get_indexed("prefilter")
                       if p and pathlib.Path(p).exists()]
    if prefilter_paths:
        merged: dict[str, str] = {}
        for p in prefilter_paths:
            merged.update(FastaStore.from_file(p)._seqs)
        if short_k is not None:
            prefilter_index = SeedIndex(merged, seed_len=short_k)
        elif len(prefilter_paths) == 1:
            prefilter_index = SeedIndex.load_or_build(prefilter_paths[0])
        else:
            prefilter_index = SeedIndex(merged)
    _tmark("seed indices")
    ig_genes = set()
    if config.has_value("ig_gene_list"):
        with open(config.get_value("ig_gene_list")) as fh:
            ig_genes = {line.strip() for line in fh if line.strip()}

    # the one change from defuse_tpu: the port's verifier, with no device
    # probe and no cost model; with the native library present, auto mode
    # keeps the fused C++ seed+verify
    verify_fn = None
    mode = os.environ.get("DEFUSE_DEVICE_VERIFY", "auto")
    if dev is not None and mode != "off" \
            and (not native.available() or mode == "force"):
        verify_fn = DeviceVerifier(dev)

    def run_shard(r1, r2, outdir, frag_base=0, append=False):
        return align_job(
            cdna_index=cdna_index, genome_index=genome_index,
            rrna_index=rrna_index, gene_models=gene_models,
            reads1=r1, reads2=r2, outdir=str(outdir),
            max_insert_size=config.get_int("max_insert_size"),
            discord_read_trim=config.get_int("discord_read_trim"),
            max_paired_alignments=config.get_int("max_paired_alignments"),
            dna_concordant_length=config.get_int("dna_concordant_length"),
            ig_genes=ig_genes, verify_fn=verify_fn,
            prefilter_index=prefilter_index, frag_base=frag_base,
            append=append,
            # "lazy" (default) skips the pair-SAM text checkpoint on the
            # native path; consumers regenerate it from the binary table
            write_sam=config.get_value("pair_sam_checkpoint") != "lazy"
            if config.has_value("pair_sam_checkpoint") else False)

    def slice_reads(reads, lo, hi):
        if isinstance(reads, tuple):
            return (reads[0][lo:hi], reads[1][lo:hi])
        return reads[lo:hi]

    n_frags = len(reads1[1]) if isinstance(reads1, tuple) else len(reads1)
    reads_per_job = config.get_int("reads_per_job")
    if n_frags > reads_per_job:
        # data-parallel frontend shards bound per-shard memory at
        # reads_per_job pairs; sequential shards emit globally-correct
        # fragment ids (frag_base) and append straight into the final
        # artifact files (shard 0 truncates)
        res = None
        for si, lo in enumerate(range(0, n_frags, reads_per_job)):
            hi = min(lo + reads_per_job, n_frags)
            res = run_shard(
                slice_reads(reads1, lo, hi), slice_reads(reads2, lo, hi),
                out / "aligned", frag_base=frag_base + lo, append=si > 0)
            _tmark(f"shard {si} ({hi - lo} pairs)")
    else:
        res = run_shard(reads1, reads2, out / "aligned",
                        frag_base=frag_base)
    return {
        "spanning": res["spanning"], "improper": res["improper"],
        "fastq1": str(out / "reads" / "reads.1.fastq"),
        "fastq2": str(out / "reads" / "reads.2.fastq"),
        "concordant_sam": res["concordant_sam"],
        "pair_table": res.get("pair_table"),
        # reuse the indices for the breakpoint alignment stage
        "target_indices": {"genome": genome_index, "cdna": cdna_index},
    }
