"""The port's command line against ``defuse_tpu``'s.

The eight verbs take the reference's flags (plus ``--device`` on ``run``
and ``cohort``); ``create-ref``, ``run`` and ``cohort`` through
``cli.main.main`` write what the reference's write, byte for byte (no
tolerance), from the same seeded fastqs; the read-only verbs print the
same text about the same run."""

import filecmp
import importlib.util
import json
import os
import pathlib
import subprocess
import sys

import pytest

from defuse_tpu.cli import main as jax_cli
from defuse_tpu_torch.cli import main as port_cli
from defuse_tpu_torch.utils import synth

from synthdata import make_dataset, write_dataset
from test_stats_filters import _make_concordant_sam

REPO = pathlib.Path(__file__).resolve().parent.parent
VERBS = ("run", "create-ref", "cohort", "get-reads", "cluster-sequences",
         "expression-plot", "export", "bamfastq")


def verbs(parser):
    (sub,) = [a for a in parser._actions if a.dest == "command"]
    return sub.choices


def flags(parser):
    return [(tuple(a.option_strings), a.dest, a.default, a.required,
             a.help, tuple(a.choices) if a.choices else None, a.nargs)
            for a in parser._actions]


@pytest.mark.parametrize("verb", VERBS)
def test_verb_takes_the_reference_flags(verb):
    ref_parsers = verbs(jax_cli.build_parser())
    port_parsers = verbs(port_cli.build_parser())
    assert tuple(port_parsers) == tuple(ref_parsers) == VERBS
    want, got = flags(ref_parsers[verb]), flags(port_parsers[verb])
    extra = [f for f in got if f[0] == ("--device",)]
    assert len(extra) == (1 if verb in ("run", "cohort") else 0)
    for f in extra:
        assert f[2] == "cuda" and f[5] == ("cuda", "cpu")
    got = [f for f in got if f[0] != ("--device",)]
    if verb == "run":  # the one help text that named the TPU
        want = [f[:4] + ("",) + f[5:] if f[0] == ("--no-device",) else f
                for f in want]
        got = [f[:4] + ("",) + f[5:] if f[0] == ("--no-device",) else f
               for f in got]
    assert got == want
    assert port_parsers[verb].prog == ref_parsers[verb].prog


@pytest.mark.parametrize("verb,rest", [
    ("run", ["-c", "c", "-d", "d", "-o", "o", "-1", "a", "-2", "b"]),
    ("cohort", ["-c", "c", "-d", "d", "-m", "m", "-o", "o"])])
def test_device_defaults_to_cuda_and_raises_without_a_card(verb, rest,
                                                           tmp_path):
    import torch
    assert port_cli.build_parser().parse_args([verb] + rest).device == "cuda"
    if torch.cuda.is_available():
        pytest.skip("CUDA is available here")
    config = tmp_path / "config.txt"
    config.write_text("span_count_threshold = 3\n")
    rest = [str(config) if a == "c" else str(tmp_path / a) if len(a) == 1
            and a.isalpha() else a for a in rest]
    with pytest.raises(RuntimeError, match="is_available"):
        port_cli.main([verb] + rest)
    assert not (tmp_path / "o").exists()


@pytest.fixture(scope="module")
def library(tmp_path_factory):
    """A seeded library with its config, and the dataset directory that
    each package's ``create-ref`` derived from it."""
    tmp = tmp_path_factory.mktemp("torch_cli")
    ds = make_dataset(seed=7, n_fusion_frags=80, n_background_frags=40)
    paths = write_dataset(ds, tmp / "data")
    config = synth.write_run_config(ds, tmp / "refs")
    assert jax_cli.main(["create-ref", "-c", str(config), "-d",
                         str(tmp / "dataset_jax")]) == 0
    assert port_cli.main(["create-ref", "-c", str(config), "-d",
                          str(tmp / "dataset_port")]) == 0
    return tmp, ds, paths, config


def test_create_ref_writes_the_reference_dataset(library):
    tmp, _ds, _paths, _config = library
    names = sorted(p.name for p in (tmp / "dataset_jax").iterdir())
    assert "defuse.cdna.fa" in names and "defuse.reference.fa" in names
    match, mismatch, errors = filecmp.cmpfiles(
        tmp / "dataset_jax", tmp / "dataset_port", names, shallow=False)
    assert sorted(match) == names, (mismatch, errors)


@pytest.fixture(scope="module")
def cli_runs(library):
    tmp, _ds, paths, config = library
    common = ["-c", str(config), "-1", str(paths["fastq1"]), "-2",
              str(paths["fastq2"]), "-n", "cli"]
    assert jax_cli.main(["run", "-d", str(tmp / "dataset_jax"), "-o",
                         str(tmp / "run_jax"), "--no-device"] + common) == 0
    assert port_cli.main(["run", "-d", str(tmp / "dataset_port"), "-o",
                          str(tmp / "run_port"), "--device", "cpu"]
                         + common) == 0
    return tmp / "run_jax", tmp / "run_port"


@pytest.mark.parametrize("name", [
    "results.tsv", "results.classify.tsv", "results.filtered.tsv",
    "annotations", "concordant.read.stats", "clusters.sc",
    "splitreads.alignments", "splitreads.break"])
def test_cli_run_matches_jax_package(cli_runs, name):
    want, got = cli_runs
    assert (got / name).read_bytes() == (want / name).read_bytes()
    assert (got / name).stat().st_size > 0


def test_cli_run_calls_the_planted_fusion(cli_runs):
    _want, got = cli_runs
    rows = [r.split("\t") for r in
            (got / "results.filtered.tsv").read_text().splitlines()]
    g1, g2 = rows[0].index("gene1"), rows[0].index("gene2")
    assert any({r[g1], r[g2]} == {"GA", "GB"} for r in rows[1:])


@pytest.fixture(scope="module")
def index_runs(library, cli_runs):
    """The port's ``run`` of ``cli_runs`` beside two more: one whose
    frontend hands breakseq the saved genome and cDNA indices, mapped by
    hand (as the frontend did before it let mapped indices go), and one on
    the short-read route (``discord_read_trim`` 40: the frontend builds
    both indices in memory at k 13)."""
    from defuse_tpu_torch.align import frontend
    from defuse_tpu_torch.align.seedindex import SeedIndex
    tmp, _ds, paths, config = library
    align = frontend.align_reads

    def handing(config, *args, **kw):
        out = align(config, *args, **kw)
        assert out["target_indices"] == {}
        prefix = config.get_value("dataset_prefix") + ".genome.seedidx"
        out["target_indices"] = {
            "genome": SeedIndex.load_or_build(
                config.get_value("genome_fasta"), prefix=prefix),
            "cdna": SeedIndex.load_or_build(config.get_value("cdna_fasta"))}
        return out

    short = tmp / "refs" / "config.short.txt"
    short.write_text(config.read_text() + "discord_read_trim = 40\n")
    common = ["-d", str(tmp / "dataset_port"), "-1", str(paths["fastq1"]),
              "-2", str(paths["fastq2"]), "-n", "cli", "--device", "cpu"]
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(frontend, "align_reads", handing)
        assert port_cli.main(["run", "-c", str(config), "-o",
                              str(tmp / "run_handed")] + common) == 0
    assert port_cli.main(["run", "-c", str(short), "-o",
                          str(tmp / "run_short")] + common) == 0
    return {"saved": cli_runs[1], "handed": tmp / "run_handed",
            "short_read": tmp / "run_short"}


@pytest.mark.parametrize("name", [
    "results.tsv", "splitreads.seq", "splitreads.break",
    "splitreads.alignments", "breakpoints.genome.psl",
    "breakpoints.genome.nointron.psl", "breakpoints.cdna.psl",
    "breakpoints.exons.psl", "breakpoints.cds.psl"])
def test_cli_run_is_the_same_with_the_indices_handed_in(index_runs, name):
    """Breakseq mapping the saved indices itself writes what it wrote when
    the frontend handed them on, byte for byte."""
    got, want = index_runs["saved"] / name, index_runs["handed"] / name
    assert got.read_bytes() == want.read_bytes()
    assert got.stat().st_size > 0


@pytest.mark.parametrize("route,handed", [("saved", 0), ("handed", 2),
                                          ("short_read", 2)])
def test_breakseq_counts_the_indices_it_maps_and_is_handed(index_runs,
                                                           route, handed):
    """``breakseq.index_load`` counts the targets the frontend handed on
    (``handed``) and those the stage loads itself (``mapped``): with the
    dataset's saved indices every target is the stage's own."""
    spans = json.loads((index_runs[route] / "metrics.json").read_text()
                       )["spans"]
    (load,) = [s for s in spans if s["name"] == "breakseq.index_load"]
    passes = [s for s in spans if s["name"].startswith("breakseq.align.")]
    assert len(passes) == 4
    assert load["counts"]["handed"] == handed
    assert load["counts"]["mapped"] == len(passes) - handed


def read_only_verbs(tmp, run_dir, dataset, config):
    cid = (run_dir / "results.tsv").read_text().splitlines()[1].split("\t")[0]
    return {
        "get-reads": ["get-reads", "-c", str(config), "-d", str(dataset),
                      "-o", str(run_dir), "-i", cid],
        "cluster-sequences": [
            "cluster-sequences", "-r",
            str(dataset / "defuse.reference.fa"), "--clusters",
            str(run_dir / "clusters.sc")],
        "export": ["export", "circos-links", "-i",
                   str(run_dir / "results.classify.tsv"), "-o",
                   str(tmp / f"links.{run_dir.name}.txt")],
    }


@pytest.mark.parametrize("verb", ["get-reads", "cluster-sequences",
                                  "export"])
def test_read_only_verb_prints_what_the_reference_prints(library, cli_runs,
                                                         verb):
    tmp, _ds, _paths, config = library
    run_jax, run_port = cli_runs
    argv_jax = read_only_verbs(tmp, run_jax, tmp / "dataset_jax",
                               config)[verb]
    argv_port = read_only_verbs(tmp, run_port, tmp / "dataset_port",
                                config)[verb]
    # the verbs' writers bind sys.stdout when their module is imported, which
    # pytest's capture may have replaced since: run them as programs
    want, got = (subprocess.run(
        [sys.executable, "-m", package] + argv, capture_output=True,
        text=True, cwd=REPO, timeout=120, check=True).stdout
        for package, argv in (("defuse_tpu", argv_jax),
                              ("defuse_tpu_torch", argv_port)))
    if verb == "export":
        want = (tmp / "links.run_jax.txt").read_text()
        got = (tmp / "links.run_port.txt").read_text()
    assert got == want and got.strip()


def test_cli_run_prealigned_on_the_cpu(tmp_path):
    """``run --prealigned --device cpu``: an external aligner's files in,
    the reference's results out."""
    ds = make_dataset(seed=63)
    paths = write_dataset(ds, tmp_path / "pre")
    _make_concordant_sam(ds, tmp_path / "pre" / "concordant.sam",
                         n_pairs=600)
    config = tmp_path / "config.txt"
    config.write_text(f"reference_fasta = {paths['reference']}\n"
                      f"cdna_regions = {paths['exons']}\n"
                      "span_count_threshold = 3\n")
    common = ["-c", str(config), "-d", str(tmp_path), "-1",
              str(paths["fastq1"]), "-2", str(paths["fastq2"]),
              "--prealigned", str(tmp_path / "pre")]
    assert jax_cli.main(["run", "-o", str(tmp_path / "jax"), "--no-device"]
                        + common) == 0
    assert port_cli.main(["run", "-o", str(tmp_path / "port"), "--device",
                          "cpu"] + common) == 0
    for name in ("results.tsv", "concordant.read.stats", "cov.merged.tsv",
                 "splitreads.seq"):
        assert (tmp_path / "port" / name).read_bytes() == \
            (tmp_path / "jax" / name).read_bytes(), name
    assert len((tmp_path / "port" / "results.tsv").read_text()
               .splitlines()) >= 2


@pytest.fixture(scope="module")
def cohorts(library):
    """Two libraries (the fixture's reads dealt out in turn) through each
    package's ``cohort``; the children are ``python -m <package> run``."""
    tmp, _ds, paths, config = library
    mp = pytest.MonkeyPatch()
    mp.setenv("PYTHONPATH", str(REPO))
    mp.setenv("JAX_PLATFORMS", "cpu")
    halves = []
    for end in "12":
        dsts = [tmp / f"lib{x}.{end}.fastq" for x in "AB"]
        synth.deal_fastq(paths[f"fastq{end}"], dsts)
        halves.append(dsts)
    manifest = tmp / "cohort.tsv"
    manifest.write_text("".join(
        f"lib{x}\t{halves[0][i]}\t{halves[1][i]}\n"
        for i, x in enumerate("AB")))
    try:
        assert jax_cli.main([
            "cohort", "-c", str(config), "-d", str(tmp / "dataset_jax"),
            "-m", str(manifest), "-o", str(tmp / "cohort_jax"), "-w", "2",
            "--no-device"]) == 0
        assert port_cli.main([
            "cohort", "-c", str(config), "-d", str(tmp / "dataset_port"),
            "-m", str(manifest), "-o", str(tmp / "cohort_port"), "-w", "2",
            "--device", "cpu"]) == 0
    finally:
        mp.undo()
    return tmp / "cohort_jax", tmp / "cohort_port"


@pytest.mark.parametrize("name", ["cohort_fusions.tsv",
                                  "cohort_recurrent.tsv"])
def test_cohort_matches_jax_package(cohorts, name):
    want, got = cohorts
    assert (got / name).read_bytes() == (want / name).read_bytes()
    assert len((got / name).read_text().splitlines()) >= 2


def test_cohort_libraries_ran_the_port_on_the_cpu(cohorts):
    _want, got = cohorts
    summary = (got / "cohort_summary.tsv").read_text().splitlines()
    assert [ln.split("\t")[:2] for ln in summary[1:]] == \
        [["libA", "ok"], ["libB", "ok"]]
    for lib in ("libA", "libB"):
        log = (got / lib / "cohort.log").read_text()
        assert "Traceback" not in log
        assert (got / lib / "metrics.discover.json").exists()
        spans = json.loads((got / lib / "metrics.json").read_text())["spans"]
        (load,) = [s for s in spans if s["name"] == "breakseq.index_load"]
        assert (load["counts"]["handed"], load["counts"]["mapped"]) == (0, 4)


def cohort_reference():
    """``fusionbench/cohort_reference.py``, the benchmark's plain reference
    of the cohort's tables."""
    spec = importlib.util.spec_from_file_location(
        "cohort_reference", REPO / "fusionbench" / "cohort_reference.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@pytest.mark.parametrize("name", ["cohort_fusions.tsv",
                                  "cohort_recurrent.tsv"])
def test_cohort_tables_equal_the_plain_reference(cohorts, name):
    """The two libraries share their fusions, so a gene pair recurs in
    both."""
    _want, got = cohorts
    ref = cohort_reference()
    tables = ref.tables(got, ref.manifest_names(got.parent / "cohort.tsv"))
    assert (got / name).read_bytes() == tables[name].encode()
    recurrent = [r.split("\t") for r in
                 tables["cohort_recurrent.tsv"].splitlines()[1:]]
    assert recurrent[0][2:] == ["2", "libA,libB"]


def test_cohort_library_records_its_queue_and_start(cohorts, cli_runs):
    """A cohort library's ``metrics.json`` holds its time in the queue and
    its process start, before its run's spans, and the counters of what
    it shares the host with; a plain ``run``'s holds none of them."""
    _want, got = cohorts
    for lib in ("libA", "libB"):
        metrics = json.loads((got / lib / "metrics.json").read_text())
        spans = metrics["spans"]
        wait, spawn = spans[:2]
        assert [wait["name"], spawn["name"]] == ["cohort.wait",
                                                 "cohort.spawn"]
        assert wait["parent"] is None and spawn["parent"] is None
        assert wait["start_ns"] <= wait["end_ns"] == spawn["start_ns"] < \
            spawn["end_ns"] <= spans[2]["start_ns"]
        assert wait["counts"] == spawn["counts"] == {}
        assert "cohort.spawn" not in metrics["memory"]["rise"]
        counters = metrics["counters"]
        assert counters["cohort_workers"] == 2
        assert counters["cpus"] == len(os.sched_getaffinity(0))
        assert counters["torch_threads"] >= 1
    _jax, plain = cli_runs
    metrics = json.loads((plain / "metrics.json").read_text())
    assert not any(s["name"].startswith("cohort.")
                   for s in metrics["spans"])
    assert not {"cohort_workers", "cpus", "torch_threads"} & \
        set(metrics["counters"])


def test_main_module_is_the_cli():
    proc = subprocess.run([sys.executable, "-m", "defuse_tpu_torch",
                           "--help"], capture_output=True, text=True,
                          cwd=REPO, timeout=120)
    assert proc.returncode == 0
    for verb in VERBS:
        assert verb in proc.stdout
    assert proc.stdout.startswith("usage: defuse-tpu")
