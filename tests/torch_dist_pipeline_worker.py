"""Worker for tests/test_torch_distributed.py's two-process pipeline parity
run of the port (the reference's "2-host data-parallel parity" config, on
the CPU with gloo).

Each rank aligns its fastq shard with globally-offset fragment ids (the
``frag_base`` contract), merges the read-stats sums across ranks through
the live process group and waits at a barrier.  Rank 0 then merges the
shard artifacts and runs ``run_pipeline(dist=ctx)`` on the per-rank pair
tables and read stores (the screen as its plain PyTorch version,
``device="cpu"``), while rank 1 samples covariance over its own table part
and clusters its bin-pair partition (``tail_partition_worker``).  The test
holds rank 0's results to a one-process run of the port and of
``defuse_tpu``.  Imports no ``jax``.  Usage: torch_dist_pipeline_worker.py
<workdir>.
"""

import json
import os
import pathlib
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))

TIMEOUT_S = 300


def main():
    work = pathlib.Path(sys.argv[1])
    meta = json.loads((work / "meta.json").read_text())

    from defuse_tpu_torch.align.frontend import align_job
    from defuse_tpu_torch.align.seedindex import SeedIndex
    from defuse_tpu_torch.annotate.gene_models import GeneModels
    from defuse_tpu_torch.cluster import native
    from defuse_tpu_torch.config import Config
    from defuse_tpu_torch.io.fasta import FastaStore
    from defuse_tpu_torch.parallel.launch import (
        DistContext, allgather_read_stats_sums, init_distributed,
        merge_artifacts, tail_partition_worker)

    pid, n_proc = init_distributed(timeout=TIMEOUT_S)
    assert n_proc == int(meta["n_shards"])
    ctx = DistContext(pid, n_proc)

    # deterministic index build from the shared dataset files
    cdna = FastaStore.from_file(meta["cdna_fasta"])
    cdna_index = SeedIndex({name: cdna.sequence(name)
                            for name in cdna._seqs})
    genome = FastaStore.from_file(meta["genome_fasta"])
    genome_index = SeedIndex({name: genome.sequence(name)
                              for name in genome._seqs})
    gm = GeneModels(meta["gtf"])

    # each rank ingests its shard (renamed ids from 0, an indexed read
    # store) and aligns it with the shard's global fragment-id base
    prefix = meta["shard_prefixes"][pid]
    shard_dir = work / f"shard{pid}"
    reads1, reads2 = native.ingest_fastq(
        f"{prefix}.1.fastq", f"{prefix}.2.fastq", str(shard_dir / "reads"))
    align_job(cdna_index=cdna_index, genome_index=genome_index,
              rrna_index=None, gene_models=gm, reads1=reads1,
              reads2=reads2, outdir=str(shard_dir),
              frag_base=pid * int(meta["per_shard"]))

    # exact cross-rank read-stats merge from the raw sums of each part
    sums = native.read_stats_tbl_sums(shard_dir / "cdna.pair.tbl")
    merged_stats = allgather_read_stats_sums(*sums)
    (shard_dir / "stats.merged").write_text(merged_stats.format())

    # every shard's artifacts must be on disk before rank 0 merges
    ctx.barrier("frontend_done")

    if pid != 0:
        tail_partition_worker(ctx, work / "out_dist",
                              pair_table=shard_dir / "cdna.pair.tbl")
    else:
        from defuse_tpu_torch.pipeline.run import run_pipeline
        grouped = []
        reads_group = native.reads_group
        native.reads_group = \
            lambda *a: grouped.append(reads_group(*a)) or grouped[-1]
        shard_dirs = [work / f"shard{p}" for p in range(n_proc)]
        merged = merge_artifacts(shard_dirs, work / "merged")
        config = Config.defaults(
            reference_fasta=meta["reference"], cdna_regions=meta["exons"],
            span_count_threshold=3)
        outs = run_pipeline(
            config=config, output_dir=str(work / "out_dist"),
            library_name="dist-parity",
            spanning=merged["spanning.compact"],
            improper=merged["improper.sam"],
            fastq1=meta["fastq1"], fastq2=meta["fastq2"],
            concordant_sam=None, read_stats=merged_stats,
            pair_table=[str(d / "cdna.pair.tbl") for d in shard_dirs],
            reads_sources=[(str(d / "reads" / "reads.1.fastq"),
                            str(d / "reads" / "reads.2.fastq"),
                            i * int(meta["per_shard"]))
                           for i, d in enumerate(shard_dirs)],
            gene_models_gtf=meta["gtf"], genome_fasta=meta["genome_fasta"],
            repeats_regions=meta["repeats"], expression=meta["expression"],
            device="cpu", dist=ctx)
        (work / "outs.json").write_text(json.dumps(
            {k: str(v) for k, v in outs.items() if v}
            | {"grouped_store": [g is not None for g in grouped]}))
    # keep every rank alive until the files are written
    ctx.barrier("pipeline_done")
    assert "jax" not in sys.modules and "defuse_tpu" not in sys.modules
    print(f"worker {pid}: ok", flush=True)


if __name__ == "__main__":
    main()
