"""Command-line interface mirroring the reference driver scripts.

``defuse-tpu run``        <- ``defuse_run.pl -c config -d dataset -o out
                             -1 fq1 -2 fq2 -n name`` (README.md:163-201)
``defuse-tpu create-ref`` <- ``defuse_create_ref.pl``
``defuse-tpu get-reads``  <- ``defuse_get_reads.pl``

``run`` and ``cohort`` put the device stages on ``--device`` (``cuda``
unless ``cpu`` is given, which takes the plain PyTorch versions) and raise
at once when that is ``cuda`` and no card is present; ``--no-device`` keeps
the whole run on the host.
"""

from __future__ import annotations

import argparse
import sys


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(prog="defuse-tpu")
    sub = p.add_subparsers(dest="command", required=True)

    run = sub.add_parser("run", help="run the fusion discovery pipeline")
    run.add_argument("-c", "--config", required=True)
    run.add_argument("-d", "--dataset", required=True,
                     help="dataset directory")
    run.add_argument("-o", "--output", required=True)
    run.add_argument("-1", "--fastq1", dest="fastq1", default=None)
    run.add_argument("-2", "--fastq2", dest="fastq2", default=None)
    run.add_argument("-b", "--bam", default=None,
                     help="paired BAM input (converted via the built-in "
                          "bamfastq; replaces -1/-2, defuse.pl --bam)")
    run.add_argument("-n", "--name", default="defuse-tpu-library")
    run.add_argument("-s", "--submit", default="direct",
                     help="direct | (cluster submitters TBD)")
    run.add_argument("-p", "--parallel", type=int, default=1)
    run.add_argument("--report-margin", type=int, default=0,
                     metavar="N",
                     help="append probability_mean/probability_sd "
                          "columns from an N-seed classifier bagging "
                          "sweep to results.classify.tsv, surfacing "
                          "borderline calls near the probability "
                          "threshold (see MIGRATION.md 'classifier "
                          "margins at depth'; default 0 = off, output "
                          "identical to deFuse's)")
    run.add_argument("--no-device", action="store_true",
                     help="host-only compute (no device stage)")
    _add_device_argument(run)
    run.add_argument("--prealigned", default=None,
                     help="directory with spanning.compact, improper.sam,"
                          " concordant.sam from an external aligner")

    ref = sub.add_parser("create-ref", help="build the reference dataset")
    ref.add_argument("-c", "--config", required=True)
    ref.add_argument("-d", "--dataset", required=True)

    coh = sub.add_parser(
        "cohort", help="run a multi-library cohort (manifest of "
                       "libraries; per-library pipelines + cohort-wide "
                       "fusion recurrence summary)")
    coh.add_argument("-c", "--config", required=True)
    coh.add_argument("-d", "--dataset", required=True)
    coh.add_argument("-m", "--manifest", required=True,
                     help="TSV name<TAB>fastq1<TAB>fastq2 (or JSON list)")
    coh.add_argument("-o", "--output", required=True)
    coh.add_argument("-w", "--workers", type=int, default=1,
                     help="concurrent libraries per process")
    coh.add_argument("--no-device", action="store_true")
    _add_device_argument(coh)

    reads = sub.add_parser("get-reads",
                           help="supporting reads for one cluster "
                                "(text report, or fastq export with "
                                "--fastq1/--fastq2)")
    reads.add_argument("-c", "--config", required=True)
    reads.add_argument("-d", "--dataset", required=True)
    reads.add_argument("-o", "--output", required=True)
    reads.add_argument("-i", "--id", type=int,
                       help="cluster id (mutually exclusive with --list)")
    reads.add_argument("-l", "--list", dest="id_list",
                       help="file of cluster ids, one per line "
                            "(get_fusion_fastq.pl batch mode)")
    reads.add_argument("--fastq1", help="end-1 fastq output "
                                        "(fastq export mode)")
    reads.add_argument("--fastq2", help="end-2 fastq output")

    cseq = sub.add_parser(
        "cluster-sequences",
        help="approximate fusion sequences from cluster extents "
             "(get_fusion_sequences.pl)")
    cseq.add_argument("-r", "--reference", required=True,
                      help="reference fasta")
    cseq.add_argument("--clusters", required=True,
                      help="clusters file (e.g. clusters.sc)")

    eplot = sub.add_parser("expression-plot",
                           help="per-gene exonic expression plot "
                                "(expression_plot.pl)")
    eplot.add_argument("-c", "--config", required=True)
    eplot.add_argument("-d", "--dataset", required=True)
    eplot.add_argument("-o", "--output", required=True,
                       help="library output directory")
    eplot.add_argument("-g", "--gene", required=True)
    eplot.add_argument("-f", "--fusid", type=int, default=None)
    eplot.add_argument("-r", "--res", default=None,
                       help="results file (default: output/results.tsv)")
    eplot.add_argument("-p", "--pdf", required=True,
                       help="plot output path (.pdf/.png)")

    exp = sub.add_parser(
        "export", help="format converters / circos exporters "
                       "(results_to_circos, qseq2fastq, fq_all2std)")
    exp.add_argument("kind", choices=["circos-links", "circos-points",
                                      "qseq2fastq", "fq-all2std",
                                      "pair-sam", "cov-samples"])
    exp.add_argument("-i", "--input", required=True,
                     help="results.tsv / expression.txt / qseq / fastq "
                          "/ run output dir (pair-sam, cov-samples)")
    exp.add_argument("-o", "--output", required=True)
    exp.add_argument("-c", "--config", help="config file (cov-samples)")
    exp.add_argument("-d", "--dataset",
                     help="dataset directory (cov-samples)")
    exp.add_argument("-g", "--gtf",
                     help="gene models gtf (circos-points)")
    exp.add_argument("--filtered-only", action="store_true",
                     help="circos-links: only rows past the "
                          "probability threshold")
    exp.add_argument("--threshold", type=float, default=0.5)

    bamq = sub.add_parser("bamfastq",
                          help="BAM -> paired fastq (bamfastq tool)")
    bamq.add_argument("-b", "--bam", required=True)
    bamq.add_argument("-1", "--fastq1", dest="fastq1", required=True)
    bamq.add_argument("-2", "--fastq2", dest="fastq2", required=True)
    bamq.add_argument("-r", "--rename", action="store_true")
    bamq.add_argument("-m", "--multiples", action="store_true")
    bamq.add_argument("-p", "--paired-names", action="store_true")
    return p


def _add_device_argument(parser) -> None:
    parser.add_argument("--device", choices=["cuda", "cpu"], default="cuda",
                        help="where the device stages run: cuda (the "
                             "kernels; raises when no card is present) or "
                             "cpu (their plain PyTorch versions)")


def _find_or_materialize_pair_sam(out_dir):
    """Locate the concordant pair SAM under a run directory,
    regenerating it from the binary pair table when the frontend ran
    with the lazy checkpoint (pair_sam_checkpoint=lazy).  An existing
    SAM older than the pair table (a lazy rerun over an old eager
    dir) is treated as stale and regenerated."""
    import pathlib
    out_dir = pathlib.Path(out_dir)
    tbl_path = next((out_dir / t for t in
                     ("cdna.pair.tbl", "aligned/cdna.pair.tbl")
                     if (out_dir / t).exists()), None)
    tbl_mtime = tbl_path.stat().st_mtime if tbl_path else None
    for cand in ("cdna.pair.sam.gz", "cdna.pair.sam",
                 "aligned/cdna.pair.sam.gz", "aligned/cdna.pair.sam"):
        p = out_dir / cand
        if p.exists() and (tbl_mtime is None
                           or p.stat().st_mtime >= tbl_mtime):
            return p
    from ..io.readindex import store_present
    if tbl_path is not None \
            and store_present(out_dir / "reads" / "reads"):
        from ..align.frontend import pair_sam_from_tbl
        return pathlib.Path(pair_sam_from_tbl(
            tbl_path, out_dir / "reads" / "reads",
            out_dir / "cdna.pair.sam.gz"))
    return out_dir / "cdna.pair.sam.gz"  # original not-found behavior


def main(argv=None) -> int:
    args = build_parser().parse_args(argv)
    from ..config import Config

    if args.command == "run":
        config = Config.read(args.config, args.dataset)
        if args.report_margin:
            config = config.with_value("report_margin_seeds",
                                       args.report_margin)
        from ..pipeline.run import run_pipeline
        if not args.no_device:
            from ..core.devices import require_cuda
            require_cuda(args.device)
        if args.bam:
            if args.fastq1 or args.fastq2:
                raise SystemExit("give either --bam or -1/-2, not both")
            import pathlib
            from ..io.bam import bam_to_fastq
            bdir = pathlib.Path(args.output) / "bamfastq"
            bdir.mkdir(parents=True, exist_ok=True)
            args.fastq1 = str(bdir / "reads.1.fastq")
            args.fastq2 = str(bdir / "reads.2.fastq")
            bam_to_fastq(args.bam, args.fastq1, args.fastq2)
        elif not (args.fastq1 and args.fastq2):
            raise SystemExit("run needs -1/-2 fastqs or --bam")
        if args.prealigned:
            import pathlib
            pre = pathlib.Path(args.prealigned)
            outs = run_pipeline(
                config=config, output_dir=args.output,
                library_name=args.name,
                spanning=str(pre / "spanning.compact"),
                improper=str(pre / "improper.sam"),
                fastq1=args.fastq1, fastq2=args.fastq2,
                concordant_sam=str(pre / "concordant.sam")
                if (pre / "concordant.sam").exists() else None,
                gene_models_gtf=config.get_value("gene_models")
                if config.has_value("gene_models") else None,
                genome_fasta=config.get_value("genome_fasta")
                if config.has_value("genome_fasta") else None,
                repeats_regions=config.get_value("repeats_regions")
                if config.has_value("repeats_regions") else None,
                use_device=not args.no_device, device=args.device)
        else:
            from ..align.frontend import align_reads
            aligned = align_reads(config, args.output, args.fastq1,
                                  args.fastq2,
                                  use_device=not args.no_device,
                                  device=args.device)
            outs = run_pipeline(
                config=config, output_dir=args.output,
                library_name=args.name, use_device=not args.no_device,
                device=args.device,
                gene_models_gtf=config.get_value("gene_models")
                if config.has_value("gene_models") else None,
                genome_fasta=config.get_value("genome_fasta")
                if config.has_value("genome_fasta") else None,
                repeats_regions=config.get_value("repeats_regions")
                if config.has_value("repeats_regions") else None,
                **aligned)
        print(outs["results"])
        return 0

    if args.command == "cohort":
        from ..pipeline.cohort import run_cohort
        outs = run_cohort(args.config, args.dataset, args.manifest,
                          args.output, workers=args.workers,
                          use_device=not args.no_device,
                          device=args.device)
        if outs:
            print(outs["summary"])
        return 0

    if args.command == "create-ref":
        import pathlib

        from ..pipeline.create_ref import create_reference
        config = Config.read(args.config, args.dataset)
        # acquisition (defuse_create_ref.pl:134-237): when the raw
        # inputs are absent but Ensembl/UCSC versions are configured,
        # download + derive first (resumable; checksums recorded)
        def _missing(key):
            return (config.has_value(key)
                    and not pathlib.Path(config.get_value(key)).exists())

        need_fetch = config.has_value("ensembl_version") and any(
            _missing(k) for k in
            ("genome_fasta", "gene_models", "repeats_filename",
             "est_fasta", "est_alignments", "unigene_fasta"))
        if need_fetch:
            from ..pipeline.acquire import acquire_dataset
            acquire_dataset(config, args.dataset)
        create_reference(config, args.dataset)
        return 0

    if args.command == "get-reads":
        if (args.id is None) == (args.id_list is None):
            print("get-reads: exactly one of --id / --list is required",
                  file=sys.stderr)
            return 2
        if (args.fastq1 is None) != (args.fastq2 is None):
            print("get-reads: --fastq1 and --fastq2 go together",
                  file=sys.stderr)
            return 2
        if args.fastq1:
            from ..cli.get_reads import get_fusion_fastq
            if args.id_list:
                with open(args.id_list) as fh:
                    ids = [line.strip() for line in fh if line.strip()]
            else:
                ids = [args.id]
            get_fusion_fastq(args.output, ids, args.fastq1, args.fastq2)
            return 0
        if args.id_list:
            print("get-reads: --list requires fastq export mode "
                  "(--fastq1/--fastq2)", file=sys.stderr)
            return 2
        from ..cli.get_reads import get_reads
        config = Config.read(args.config, args.dataset)
        get_reads(config, args.output, args.id)
        return 0

    if args.command == "cluster-sequences":
        from ..cli.get_reads import cluster_sequences
        from ..io.fasta import FastaStore
        cluster_sequences(FastaStore.from_file(args.reference),
                          args.clusters)
        return 0

    if args.command == "expression-plot":
        import pathlib

        from ..cli.expression_plot import expression_plot
        config = Config.read(args.config, args.dataset)
        out_dir = pathlib.Path(args.output)
        pair_sam = _find_or_materialize_pair_sam(out_dir)
        res = expression_plot(
            concordant_sam=str(pair_sam),
            cdna_regions=config.get_value("cdna_regions"),
            gene_id=args.gene, out_path=args.pdf,
            results_path=args.res or str(out_dir / "results.tsv"),
            fusion_id=args.fusid)
        print(res["plot"] or res["table"])
        return 0

    if args.command == "export":
        from . import exporters
        if args.kind == "cov-samples":
            # materialize the covariance sample artifacts from a
            # lazy-samples run (stage emits only cov.merged.tsv; the
            # deterministic scan reproduces the exact eager bytes)
            if not args.config:
                raise SystemExit("cov-samples needs -c/--config "
                                 "(and -d/--dataset)")
            from ..pipeline.run import materialize_cov_samples
            config = Config.read(args.config, args.dataset or "")
            paths = materialize_cov_samples(config, args.input,
                                            args.output)
            for p in paths.values():
                print(p)
            return 0
        if args.kind == "pair-sam":
            # regenerate the concordant pair SAM from the binary pair
            # table (lazy pair_sam_checkpoint runs); the requested
            # output extension decides the compression, independent of
            # how the source happens to be stored
            import gzip
            import os
            import pathlib
            import shutil
            src = _find_or_materialize_pair_sam(pathlib.Path(args.input))
            if not pathlib.Path(src).exists():
                raise SystemExit(f"no pair table or SAM under "
                                 f"{args.input}")
            if os.path.exists(args.output) \
                    and os.path.samefile(src, args.output):
                print(args.output)
                return 0
            with open(src, "rb") as probe:
                src_gz = probe.read(2) == b"\x1f\x8b"
            dst_gz = args.output.endswith(".gz")
            if src_gz == dst_gz:
                shutil.copyfile(src, args.output)
            else:
                fin = gzip.open(src, "rb") if src_gz \
                    else open(src, "rb")
                fout = gzip.open(args.output, "wb", compresslevel=1) \
                    if dst_gz else open(args.output, "wb")
                with fin, fout:
                    shutil.copyfileobj(fin, fout, 1 << 20)
            print(args.output)
            return 0
        with open(args.output, "w") as out:
            if args.kind == "circos-links":
                exporters.results_to_circos_links(
                    args.input, out, filtered_only=args.filtered_only,
                    probability_threshold=args.threshold)
            elif args.kind == "circos-points":
                from ..annotate.gene_models import GeneModels
                expression = {}
                with open(args.input) as fh:
                    for line in fh:
                        f = line.rstrip("\n").split("\t")
                        if len(f) >= 2:
                            expression[f[0]] = float(f[1])
                exporters.expression_to_circos_points(
                    expression, GeneModels(args.gtf), out)
            elif args.kind == "qseq2fastq":
                with open(args.input) as fh:
                    exporters.qseq2fastq(fh, out)
            else:
                with open(args.input) as fh:
                    exporters.solexa_to_std_quality(fh, out)
        return 0

    if args.command == "bamfastq":
        from ..io.bam import bam_to_fastq
        bam_to_fastq(args.bam, args.fastq1, args.fastq2,
                     rename=args.rename, multiples=args.multiples,
                     paired_names=args.paired_names)
        return 0
    return 1


if __name__ == "__main__":
    sys.exit(main())
