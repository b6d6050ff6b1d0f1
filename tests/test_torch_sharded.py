"""The port's single-process sharded run against ``defuse_tpu``'s.

The four cases of ``tests/test_pipeline_sharded.py`` — the aligner frontend
over fastq shards merged and run whole, the binary pair table against the
SAM text path, ``align_reads`` with ``reads_per_job``, and
``align_job(frag_base=k)`` — go through both packages on the same seeded
inputs.  Inside each package the case holds what the reference's test
holds; between the packages every artifact is compared byte for byte (gzip
members after decompression, as the reference compares them): no tolerance,
the files are text printed by the same host code.  The port's device stages
run as their plain versions (``device="cpu"``)."""

import pathlib
import types

import numpy as np
import pytest

from synthdata import (make_dataset, write_dataset, write_genome_fasta,
                       write_gtf, write_repeats)
from test_pipeline_sharded import _globalize, _reads_of


def package(name):
    """The names a case needs, from ``defuse_tpu`` or ``defuse_tpu_torch``,
    with the keyword that keeps a run off an accelerator."""
    import importlib

    def mod(path):
        return importlib.import_module(f"{name}.{path}")

    frontend, shard, sam = mod("align.frontend"), mod("parallel.shard"), \
        mod("io.sam")
    host = dict(device="cpu") if name == "defuse_tpu_torch" \
        else dict(use_device=False)
    return types.SimpleNamespace(
        name=name, host=host, align_job=frontend.align_job,
        align_reads=frontend.align_reads,
        index_paired_fastq=frontend.index_paired_fastq,
        pair_sam_from_tbl=frontend.pair_sam_from_tbl,
        SeedIndex=mod("align.seedindex").SeedIndex,
        GeneModels=mod("annotate.gene_models").GeneModels,
        Config=mod("config").Config, split_fastq=shard.split_fastq,
        merge_pair_tables=shard.merge_pair_tables,
        read_pair_table=shard.read_pair_table,
        run_pipeline=mod("pipeline.run").run_pipeline,
        materialize_cov_samples=mod("pipeline.run").materialize_cov_samples,
        merge_read_stats=mod("stats.readstats").merge_read_stats,
        read_decompressed=sam.read_decompressed,
        write_fasta=mod("io.fasta").write_fasta, native=mod("cluster.native"))


PACKAGES = ("defuse_tpu", "defuse_tpu_torch")


def content(path):
    """A file's bytes, a gzip file's decompressed."""
    from defuse_tpu.io.sam import read_decompressed
    return read_decompressed(path)


def references(ds, tmp):
    gtf, genome_fa, repeats = (tmp / "genes.gtf", tmp / "genome.fa",
                               tmp / "repeats.regions")
    write_gtf(ds, gtf)
    write_genome_fasta(ds, genome_fa)
    write_repeats(ds, repeats)
    return gtf, genome_fa, repeats


def indices(pkg, ds, gtf):
    return dict(
        cdna_index=pkg.SeedIndex(
            {f"{g.name}|{g.transcript}": g.cdna(ds.genome) + "A" * 50
             for g in ds.genes}),
        genome_index=pkg.SeedIndex(ds.genome), rrna_index=None,
        gene_models=pkg.GeneModels(str(gtf)))


def run_kwargs(pkg, ds, paths, tmp, gtf, genome_fa, repeats):
    return dict(
        config=pkg.Config.defaults(
            reference_fasta=str(paths["reference"]),
            cdna_regions=str(paths["exons"]), span_count_threshold=3),
        fastq1=str(tmp / "reads" / "reads.1.fastq"),
        fastq2=str(tmp / "reads" / "reads.2.fastq"),
        gene_models_gtf=str(gtf), genome_fasta=str(genome_fa),
        repeats_regions=str(repeats),
        expression={g.name: "50" for g in ds.genes}, **pkg.host)


def both(case, tmp_path, *args):
    """{package: the case's artifacts, as {name: bytes}} for both packages,
    each in its own directory on the same seeded inputs."""
    out = {}
    for name in PACKAGES:
        tmp = tmp_path / name
        tmp.mkdir()
        out[name] = case(package(name), tmp, *args)
    return out


def assert_same_artifacts(out):
    ref, port = (out[name] for name in PACKAGES)
    assert ref.keys() == port.keys()
    for key in ref:
        assert port[key] == ref[key], key
        # one shard's share of a file may be empty; nothing else may
        assert len(ref[key]) > 0 or key.startswith("shard"), key


# --- the frontend over shards, merged, through the whole run -------------------

def sharded_pipeline(pkg, tmp, n_shards):
    ds = make_dataset(seed=31, n_fusion_frags=140, n_background_frags=100)
    paths = write_dataset(ds, tmp)
    gtf, genome_fa, repeats = references(ds, tmp)
    reads1, reads2, _ = pkg.index_paired_fastq(
        str(paths["fastq1"]), str(paths["fastq2"]), str(tmp / "reads"))
    idx = indices(pkg, ds, gtf)

    def frontend(r1, r2, outdir):
        return pkg.align_job(reads1=r1, reads2=r2, outdir=str(outdir), **idx)

    whole = frontend(reads1, reads2, tmp / "whole")
    per_shard = (len(reads1) + n_shards - 1) // n_shards
    prefixes = pkg.split_fastq(str(tmp / "reads" / "reads.1.fastq"),
                               str(tmp / "reads" / "reads.2.fastq"),
                               str(tmp / "shards"), reads_per_job=per_shard)
    assert len(prefixes) == n_shards
    merged_dir = tmp / "merged"
    merged_dir.mkdir()
    merged = {k: merged_dir / n for k, n in
              (("spanning", "spanning.compact"), ("improper", "improper.sam"),
               ("concordant_sam", "cdna.pair.sam.gz"))}
    stats_parts, tbl_parts, tbl_offsets = [], [], []
    artifacts = {}
    for i, prefix in enumerate(prefixes):
        artifacts[f"shard{i}.1.fastq"] = \
            pathlib.Path(f"{prefix}.1.fastq").read_bytes()
        res = frontend(_reads_of(f"{prefix}.1.fastq"),
                       _reads_of(f"{prefix}.2.fastq"), tmp / f"shard{i}")
        offset = i * per_shard
        for key, style in (("spanning", "frag"), ("improper", "frag/end"),
                           ("concordant_sam", "sam")):
            artifacts[f"shard{i}.{key}"] = content(res[key])
            _globalize(res[key], merged[key], offset, style)
        artifacts[f"shard{i}.pair_table"] = \
            pathlib.Path(res["pair_table"]).read_bytes()
        stats_parts.append(res["stats"])
        tbl_parts.append(res["pair_table"])
        tbl_offsets.append(offset)
    merged["pair_table"] = merged_dir / "cdna.pair.tbl"
    pkg.merge_pair_tables(tbl_parts, tbl_offsets, merged["pair_table"])
    assert merged["pair_table"].read_bytes() == \
        pathlib.Path(whole["pair_table"]).read_bytes()
    for key in ("spanning", "improper", "concordant_sam"):
        assert content(merged[key]) == content(whole[key]), key
        artifacts[f"whole.{key}"] = content(whole[key])
    artifacts["whole.pair_table"] = merged["pair_table"].read_bytes()
    stats = pkg.merge_read_stats(stats_parts)
    assert stats.frag_count == whole["stats"].frag_count
    assert abs(stats.fraglength_mean - whole["stats"].fraglength_mean) < 1e-9
    artifacts["read_stats"] = repr(
        (stats.frag_count, stats.fraglength_mean,
         stats.fraglength_stddev)).encode()

    # per-part tables with globalized ids: the distributed tail's list form
    rebased = []
    for part, off in zip(tbl_parts, tbl_offsets):
        dst = merged_dir / f"rebased.{off}.tbl"
        pkg.merge_pair_tables([part], [off], dst)
        rebased.append(str(dst))
    parts_inputs = {k: str(v) for k, v in merged.items()}
    parts_inputs.update(pair_table=rebased, concordant_sam=None)
    kw = run_kwargs(pkg, ds, paths, tmp, gtf, genome_fa, repeats)
    outs = {}
    for name, inputs in (("whole", whole),
                         ("sharded", {k: str(v) for k, v in merged.items()}),
                         ("parts", parts_inputs)):
        outs[name] = pkg.run_pipeline(
            output_dir=str(tmp / f"out_{name}"),
            library_name="shard-identity", spanning=inputs["spanning"],
            improper=inputs["improper"],
            concordant_sam=inputs["concordant_sam"],
            pair_table=inputs.get("pair_table"), **kw)
    for artifact in ("results", "classified", "filtered"):
        a = pathlib.Path(outs["whole"][artifact]).read_bytes()
        assert a == pathlib.Path(outs["sharded"][artifact]).read_bytes(), \
            f"{artifact} differs between 1 and {n_shards} shards"
        assert a == pathlib.Path(outs["parts"][artifact]).read_bytes(), \
            f"{artifact} differs for the part-table list form"
        artifacts[artifact] = a
    assert len(artifacts["results"].splitlines()) > 1
    return artifacts


@pytest.mark.parametrize("n_shards", [2, 4])
def test_sharded_pipeline_byte_identity(tmp_path, n_shards):
    assert_same_artifacts(both(sharded_pipeline, tmp_path, n_shards))


# --- the binary pair table against the SAM text path ---------------------------

def pair_table_fast_path(pkg, tmp):
    ds = make_dataset(seed=47, n_fusion_frags=120, n_background_frags=90)
    paths = write_dataset(ds, tmp)
    gtf, genome_fa, repeats = references(ds, tmp)
    reads1, reads2, _ = pkg.index_paired_fastq(
        str(paths["fastq1"]), str(paths["fastq2"]), str(tmp / "reads"))
    res = pkg.align_job(reads1=reads1, reads2=reads2,
                        outdir=str(tmp / "aligned"), **indices(pkg, ds, gtf))
    kw = run_kwargs(pkg, ds, paths, tmp, gtf, genome_fa, repeats)
    outs = {name: pkg.run_pipeline(
        output_dir=str(tmp / f"out_{name}"), library_name="tbl-equiv",
        spanning=res["spanning"], improper=res["improper"],
        concordant_sam=res["concordant_sam"], pair_table=tbl, **kw)
        for name, tbl in (("tbl", res["pair_table"]), ("sam", None))}
    artifacts = {}
    for artifact in ("results", "classified", "filtered"):
        artifacts[artifact] = pathlib.Path(outs["tbl"][artifact]).read_bytes()
        assert artifacts[artifact] == \
            pathlib.Path(outs["sam"][artifact]).read_bytes(), artifact

    def inter(name, inter):
        p = tmp / name / inter
        return content(p if p.exists() else tmp / name / (inter + ".gz"))

    for name in ("concordant.read.stats", "cov.merged.tsv"):
        artifacts[name] = inter("out_tbl", name)
        assert artifacts[name] == inter("out_sam", name), name
    mat = pkg.materialize_cov_samples(kw["config"], tmp / "aligned",
                                      tmp / "mat_cov")
    for kind in ("span", "pos", "min"):
        artifacts[f"cov.{kind}.samples"] = content(mat[kind])
        assert artifacts[f"cov.{kind}.samples"] == \
            inter("out_sam", f"cov.{kind}.samples"), kind
    assert len(artifacts["results"].splitlines()) > 1
    return artifacts


def test_pair_table_fast_path_equivalence(tmp_path):
    assert_same_artifacts(both(pair_table_fast_path, tmp_path))


# --- align_reads with reads_per_job ----------------------------------------------

def reads_per_job_sharding(pkg, tmp):
    ds = make_dataset(seed=19, n_fusion_frags=80, n_background_frags=80)
    paths = write_dataset(ds, tmp)
    gtf, genome_fa, _repeats = references(ds, tmp)
    cdna_fa = tmp / "cdna.fa"
    pkg.write_fasta(str(cdna_fa),
                    {f"{g.name}|{g.transcript}": g.cdna(ds.genome) + "A" * 50
                     for g in ds.genes})

    def run(outdir, rpj, checkpoint):
        config = pkg.Config.defaults(
            genome_fasta=str(genome_fa), gene_models=str(gtf),
            cdna_fasta=str(cdna_fa), reads_per_job=rpj,
            pair_sam_checkpoint=checkpoint)
        return pkg.align_reads(config, str(tmp / outdir),
                               str(paths["fastq1"]), str(paths["fastq2"]),
                               **pkg.host)

    whole = run("whole", 10_000_000, "eager")
    sharded = run("sharded", 40, "lazy")  # forces several shards
    artifacts = {}
    for key in ("spanning", "improper"):
        artifacts[key] = pathlib.Path(sharded[key]).read_bytes()
        assert artifacts[key] == pathlib.Path(whole[key]).read_bytes(), key
    # the lazy sharded run writes no pair SAM; the SAM regenerated from its
    # (multi-segment) pair table is the unsharded eager writer's text
    assert sharded["concordant_sam"] is None
    lazy_sam = pkg.pair_sam_from_tbl(
        sharded["pair_table"], tmp / "sharded" / "reads" / "reads",
        tmp / "lazy.pair.sam.gz")
    artifacts["concordant_sam"] = content(lazy_sam)
    assert artifacts["concordant_sam"] == content(whole["concordant_sam"])
    names_s, recs_s = pkg.read_pair_table(sharded["pair_table"])
    names_w, recs_w = pkg.read_pair_table(whole["pair_table"])
    assert names_s == names_w and len(recs_w) > 0
    assert (recs_s == recs_w).all()
    if pkg.native.available():
        stats = pkg.native.read_stats_tbl(sharded["pair_table"])
        assert stats is not None
        assert stats == pkg.native.read_stats_tbl(whole["pair_table"])
    artifacts["pair_table.sharded"] = \
        pathlib.Path(sharded["pair_table"]).read_bytes()
    artifacts["pair_table.whole"] = \
        pathlib.Path(whole["pair_table"]).read_bytes()
    artifacts["pair_table.names"] = repr(names_s).encode()
    artifacts["pair_table.records"] = np.asarray(recs_s).tobytes()
    return artifacts


def test_align_reads_reads_per_job_sharding(tmp_path):
    assert_same_artifacts(both(reads_per_job_sharding, tmp_path))


# --- align_job(frag_base=k) --------------------------------------------------------

def frag_base_global_ids(pkg, tmp, force_python):
    ds = make_dataset(seed=47, n_fusion_frags=60, n_background_frags=60)
    paths = write_dataset(ds, tmp)
    gtf = tmp / "genes.gtf"
    write_gtf(ds, gtf)
    reads1, reads2, _ = pkg.index_paired_fastq(
        str(paths["fastq1"]), str(paths["fastq2"]), str(tmp / "reads"))
    idx = indices(pkg, ds, gtf)

    def run(outdir, base):
        return pkg.align_job(reads1=reads1, reads2=reads2,
                             outdir=str(tmp / outdir), frag_base=base,
                             force_python=force_python, **idx)

    base = 1_000_000
    local, shifted = run("local", 0), run("shifted", base)
    artifacts = {}
    for key, style in (("spanning", "frag"), ("improper", "frag/end"),
                       ("concordant_sam", "sam")):
        rewritten = tmp / f"rewritten.{key}"
        _globalize(local[key], rewritten, base, style)
        artifacts[key] = content(shifted[key])
        assert artifacts[key] == content(rewritten), key
        assert artifacts[key] != content(local[key]), key
    names_l, recs_l = pkg.read_pair_table(local["pair_table"])
    names_s, recs_s = pkg.read_pair_table(shifted["pair_table"])
    assert names_l == names_s and len(recs_s) > 0
    assert (recs_s["frag"] == recs_l["frag"] + base).all()
    artifacts["pair_table"] = \
        pathlib.Path(shifted["pair_table"]).read_bytes()
    artifacts["local.pair_table"] = \
        pathlib.Path(local["pair_table"]).read_bytes()
    return artifacts


@pytest.mark.parametrize("force_python", [False, True])
def test_frag_base_global_ids(tmp_path, force_python):
    from defuse_tpu_torch.cluster import native
    if force_python is False and not native.available():
        pytest.skip("native library unavailable")
    assert_same_artifacts(both(frag_base_global_ids, tmp_path, force_python))
