"""The port's whole pipeline against ``defuse_tpu``'s on the CPU.

``run_pipeline(device="cpu")`` (the screen as its plain PyTorch version)
and ``defuse_tpu``'s ``run_pipeline(use_device=False)`` get the same seeded
prealigned inputs; every artifact is compared byte for byte (no tolerance:
the files are text printed from integers and from floats computed by the
same host code on the same machine).  The discover route without the
native library runs in subprocesses (``DEFUSE_NO_NATIVE=1`` is read once
per process) in both packages and is held to the native route too."""

import contextlib
import pathlib
import subprocess
import sys

import pytest

from defuse_tpu.config import Config as JaxConfig
from defuse_tpu.pipeline.run import run_pipeline as jax_run
from defuse_tpu_torch.cluster import discordant, native
from defuse_tpu_torch.config import Config
from defuse_tpu_torch.pipeline import discover as port_discover
from defuse_tpu_torch.pipeline import run as port_run

from synthdata import (make_dataset, write_dataset, write_genome_fasta,
                       write_gtf, write_repeats)
from test_stats_filters import _make_concordant_sam
from test_torch_discover import ARTIFACTS

REPO = pathlib.Path(__file__).resolve().parent.parent


@contextlib.contextmanager
def one_torch_thread():
    """The batched EM's tensors are small here: more threads only contend
    with the other test processes."""
    import torch
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        yield
    finally:
        torch.set_num_threads(threads)


RUN_FILES = {
    "full": ("results.tsv", "results.classify.tsv", "results.filtered.tsv",
             "annotations", "cov.span.samples", "cov.pos.samples",
             "cov.min.samples", "cov.merged.tsv", "concordant.read.stats",
             "splitreads.seq", "splitreads.break", "clusters.sc"),
    "denovo": ("results.tsv", "annotations", "denovo.seq",
               "denovo.predict", "concordant.read.stats"),
}


def run_inputs(tmp, case):
    ds = make_dataset(seed=63)
    paths = write_dataset(ds, tmp)
    concordant = tmp / "concordant.sam"
    kw = dict(library_name=case, spanning=str(paths["spanning"]),
              improper=str(paths["improper"]), fastq1=str(paths["fastq1"]),
              fastq2=str(paths["fastq2"]), concordant_sam=str(concordant))
    values = dict(reference_fasta=str(paths["reference"]),
                  cdna_regions=str(paths["exons"]), span_count_threshold=3)
    if case == "full":
        _make_concordant_sam(ds, concordant, n_pairs=3000)
        write_gtf(ds, tmp / "genes.gtf")
        write_genome_fasta(ds, tmp / "genome.fa")
        write_repeats(ds, tmp / "repeats.regions")
        kw.update(gene_models_gtf=str(tmp / "genes.gtf"),
                  genome_fasta=str(tmp / "genome.fa"),
                  repeats_regions=str(tmp / "repeats.regions"),
                  expression={g.name: "100" for g in ds.genes})
    else:
        _make_concordant_sam(ds, concordant, n_pairs=500)
        values["denovo_assembly"] = "yes"
    return kw, values


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """Both packages' runs of each case, made once: {case: (port outputs,
    reference outputs)}; the port's with its screen forced."""
    done = {}

    def get(case):
        if case not in done:
            tmp = tmp_path_factory.mktemp(f"torch_run_{case}")
            kw, values = run_inputs(tmp, case)
            with pytest.MonkeyPatch.context() as mp:
                mp.setenv("DEFUSE_DEVICE_SCREEN", "force")
                port = port_run.run_pipeline(
                    config=Config.defaults(**values),
                    output_dir=str(tmp / "port"), device="cpu", **kw)
            ref = jax_run(config=JaxConfig.defaults(**values),
                          output_dir=str(tmp / "jax"), use_device=False,
                          **kw)
            done[case] = (tmp, port, ref)
        return done[case]
    return get


@pytest.mark.parametrize("case,name", [(c, n) for c, names in
                                       RUN_FILES.items() for n in names])
def test_run_artifact_matches_jax_package(runs, case, name):
    tmp, port, ref = runs(case)
    if case == "denovo" and name.startswith("denovo."):
        key = "denovo_" + name.split(".")[1]
        got, want = pathlib.Path(port[key]), pathlib.Path(ref[key])
    else:
        got, want = tmp / "port" / name, tmp / "jax" / name
    assert want.exists(), f"the reference run wrote no {name}"
    assert got.read_bytes() == want.read_bytes()
    assert got.stat().st_size > 0


def test_run_calls_the_fusion_and_names_the_screen(runs):
    import json
    tmp, port, _ref = runs("full")
    assert set(port) == {"results", "classified", "filtered"}
    rows = [r.split("\t") for r in
            open(port["classified"]).read().splitlines()]
    g1, g2 = rows[0].index("gene1"), rows[0].index("gene2")
    assert any({r[g1], r[g2]} == {"GA", "GB"} for r in rows[1:])
    stages = [s["stage"] for s in json.loads(
        (tmp / "port" / "metrics.json").read_text())["stages"]]
    assert stages == ["discover", "pvalues", "breakseq", "annotation",
                      "denovo", "collate+classify"]
    counters = json.loads((tmp / "port" / "metrics.discover.json")
                          .read_text())["counters"]
    if native.available():
        assert counters["split_dp_impl"] == "torch"
        assert counters["screen_route"]["choice"] == "device"
        assert counters["screen_route"]["mode"] == "force"


def test_run_host_only_matches_device_cpu(runs, tmp_path):
    """``use_device=False`` (the CLI's --no-device) writes the same results
    as the run with the plain-PyTorch screen."""
    tmp, port, _ref = runs("full")
    kw, values = run_inputs(tmp_path, "full")
    host = port_run.run_pipeline(config=Config.defaults(**values),
                                 output_dir=str(tmp_path / "host"),
                                 use_device=False, **kw)
    for key in ("results", "classified", "filtered"):
        assert open(host[key]).read() == open(port[key]).read(), key


NO_NATIVE = r"""
import os, pathlib, sys
assert os.environ["DEFUSE_NO_NATIVE"] == "1"
sys.path.insert(0, {repo!r})
package, tmp = sys.argv[1], pathlib.Path(sys.argv[2])
if package == "defuse_tpu":
    import jax
    jax.config.update("jax_platforms", "cpu")
    from defuse_tpu.cluster import native
    from defuse_tpu.pipeline.discover import discover_fusions
    extra = dict(use_device=False)
else:
    import torch
    torch.set_num_threads(1)  # small tensors: threads only contend
    from defuse_tpu_torch.cluster import native
    from defuse_tpu_torch.ops import split_dp_batch, split_dp_cuda
    from defuse_tpu_torch.pipeline.discover import discover_fusions
    # "auto" without the library and with the device is the batched EM
    extra = dict(device="cpu") if package.endswith("_device") \
        else dict(device="cpu", em_mode="oracle")
    calls = []
    tie = split_dp_batch.dp_tie_columns
    split_dp_batch.dp_tie_columns = \
        lambda *a: calls.append(a[0].shape[0]) or tie(*a)
assert not native.available()
data = tmp / "data"
discover_fusions(
    spanning=str(data / "spanning.compact"),
    improper=str(data / "improper.sam"),
    fastq1=str(data / "reads.1.fastq"), fastq2=str(data / "reads.2.fastq"),
    reference=str(data / "reference.fa"), exons=str(data / "cdna.regions"),
    fragment_mean=200.0, fragment_stddev=20.0, precision=0.95,
    min_cluster_size=3, min_read_length=50, max_read_length=50,
    outdir=str(tmp / package), **extra)
if package != "defuse_tpu":
    # both sides of the winners in one call
    assert len(calls) == 1 and calls[0] > 0 and calls[0] % 2 == 0, calls
    assert split_dp_cuda.LAUNCHES == dict(split_dp_rowmax=0,
                                          split_dp_screen=0,
                                          split_dp_tie_columns=0)
    assert "jax" not in sys.modules and "defuse_tpu" not in sys.modules
print("DISCOVER_OK")
"""


@pytest.fixture(scope="module")
def no_native_runs(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("torch_no_native")
    paths = write_dataset(make_dataset(seed=31, fusion_pair=("TA", "TD"),
                                       break_a=2400, break_b=1000),
                          tmp / "data")
    import os
    env = dict(os.environ, DEFUSE_NO_NATIVE="1")
    procs = {pkg: subprocess.Popen(
        [sys.executable, "-c", NO_NATIVE.format(repo=str(REPO)), pkg,
         str(tmp)], env=env, cwd=tmp, text=True, stdout=subprocess.PIPE,
        stderr=subprocess.PIPE) for pkg in (
            "defuse_tpu", "defuse_tpu_torch", "defuse_tpu_torch_device")}
    for pkg, proc in procs.items():
        out, err = proc.communicate(timeout=600)
        assert proc.returncode == 0 and "DISCOVER_OK" in out, \
            (pkg, err[-4000:])
    return tmp, paths


@pytest.mark.parametrize("name", ARTIFACTS)
def test_no_native_discover_matches_jax_package(no_native_runs, name):
    tmp, _paths = no_native_runs
    got = (tmp / "defuse_tpu_torch" / name).read_bytes()
    assert got == (tmp / "defuse_tpu" / name).read_bytes()
    assert got


@pytest.mark.parametrize("name", ARTIFACTS)
def test_no_native_device_em_matches_jax_package(no_native_runs, name):
    """``em_mode="auto"`` without the library: the batched EM (here on CPU
    tensors) in place of the oracle, the same bytes."""
    tmp, _paths = no_native_runs
    got = (tmp / "defuse_tpu_torch_device" / name).read_bytes()
    assert got == (tmp / "defuse_tpu" / name).read_bytes()
    assert got


def test_no_native_discover_matches_native_route(no_native_runs):
    if not native.available():
        pytest.skip("native library not built")
    tmp, paths = no_native_runs
    port_discover.discover_fusions(
        spanning=str(paths["spanning"]), improper=str(paths["improper"]),
        fastq1=str(paths["fastq1"]), fastq2=str(paths["fastq2"]),
        reference=str(paths["reference"]), exons=str(paths["exons"]),
        fragment_mean=200.0, fragment_stddev=20.0, precision=0.95,
        min_cluster_size=3, min_read_length=50, max_read_length=50,
        outdir=str(tmp / "native"), device="cpu")
    for name in ARTIFACTS:
        assert (tmp / "native" / name).read_bytes() == \
            (tmp / "defuse_tpu_torch" / name).read_bytes(), name


def test_no_native_metrics_name_the_rowmax(no_native_runs):
    import json
    tmp, _paths = no_native_runs
    metrics = json.loads((tmp / "defuse_tpu_torch" /
                          "metrics.discover.json").read_text())
    assert metrics["counters"]["split_dp_impl"] == "torch"
    assert metrics["counters"]["em_impl"] == "oracle"
    assert metrics["counters"]["rowmax_instances"] == 2 * 189
    batched = json.loads((tmp / "defuse_tpu_torch_device" /
                          "metrics.discover.json").read_text())["counters"]
    assert batched["em_impl"] == "torch"
    assert batched["em_select"]["n_instances"] > 0
    assert "discover:realign:collect" in [s["stage"]
                                          for s in metrics["stages"]]


# --- what the port refuses; what it no longer refuses --------------------------

def test_run_needs_cuda_at_once(tmp_path):
    import torch
    if torch.cuda.is_available():
        pytest.skip("CUDA is available here")
    kw, values = run_inputs(tmp_path, "denovo")
    with pytest.raises(RuntimeError, match="is_available"):
        port_run.run_pipeline(config=Config.defaults(**values),
                              output_dir=str(tmp_path / "out"), **kw)
    assert not (tmp_path / "out").exists()


@pytest.mark.parametrize("kwargs,have_native", [
    (dict(em_mode="device"), True),
    (dict(em_mode="device", use_device=True), False),
    (dict(em_mode="auto", use_device=True), False)])
@pytest.mark.parametrize("table", ["empty", "fusion"])
def test_device_em_names_its_roadmap_item(monkeypatch, tmp_path, kwargs,
                                          have_native, table):
    """The batched EM is ported (ROADMAP B6/A11, struck): each way of
    asking for it runs it, on CPU tensors with ``device="cpu"``, and the
    rows are the oracle's; a card that is absent raises instead of moving
    the call."""
    import torch
    from defuse_tpu_torch.cluster import matepair_em_batch
    from defuse_tpu_torch.cluster.matepair_em import EMParams
    from defuse_tpu_torch.io.sam import iter_compact, load_alignments
    params = EMParams(200.0, 20.0, 0.95, 3)
    monkeypatch.setattr(native, "available", lambda: have_native)
    calls = []
    run_batch = matepair_em_batch.run_batch
    monkeypatch.setattr(
        matepair_em_batch, "run_batch",
        lambda *a, **kw: calls.append(kw["device"]) or run_batch(*a, **kw))

    def load():
        if table == "empty":
            return load_alignments(iter(()))
        paths = write_dataset(make_dataset(seed=31), tmp_path)
        return load_alignments(iter_compact(str(paths["spanning"])))

    with one_torch_thread():
        rows = discordant.cluster_alignments(load(), params, device="cpu",
                                             **kwargs)
    want = discordant.cluster_alignments(load(), params, em_mode="oracle")
    assert [r.format() for r in rows] == [r.format() for r in want]
    assert calls == ([] if table == "empty" else ["cpu"])
    assert (rows == []) == (table == "empty")
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="is_available"):
            discordant.cluster_alignments(load(), params, **kwargs)


@pytest.mark.parametrize("kwargs", [dict(em_mode="auto", use_device=False),
                                    dict(em_mode="oracle", use_device=True)])
def test_oracle_em_runs_without_native(monkeypatch, kwargs):
    from defuse_tpu_torch.cluster.matepair_em import EMParams
    from defuse_tpu_torch.io.sam import load_alignments
    monkeypatch.setattr(native, "available", lambda: False)
    rows = discordant.cluster_alignments(
        load_alignments(iter(())), EMParams(200.0, 20.0, 0.95, 3),
        **kwargs)
    assert rows == []


RANK_VARS = ("DEFUSE_COHORT_RANK", "DEFUSE_COHORT_NPROCS", "RANK",
             "WORLD_SIZE", "JAX_PROCESS_ID", "JAX_NUM_PROCESSES")


@pytest.mark.parametrize("env,want", [
    ({}, (0, 1)),
    ({"DEFUSE_COHORT_RANK": "2", "DEFUSE_COHORT_NPROCS": "5"}, (2, 5)),
    ({"DEFUSE_COHORT_RANK": "0"}, (0, 1)),
    ({"RANK": "1", "WORLD_SIZE": "4"}, (1, 4)),
    ({"JAX_PROCESS_ID": "3", "JAX_NUM_PROCESSES": "8"}, (3, 8)),
    ({"RANK": "1", "WORLD_SIZE": "4", "JAX_PROCESS_ID": "3",
      "JAX_NUM_PROCESSES": "8"}, (1, 4)),
    ({"DEFUSE_COHORT_RANK": "2", "DEFUSE_COHORT_NPROCS": "5", "RANK": "1",
      "WORLD_SIZE": "4"}, (2, 5)),
    ({"RANK": "1"}, (0, 1))])
def test_cohort_rank_follows_the_launcher(monkeypatch, env, want):
    """``_rank_nprocs`` under the cohort's own variables, ``torchrun``'s
    and the reference launcher's, in that order."""
    from defuse_tpu_torch.pipeline import cohort
    for name in RANK_VARS:
        monkeypatch.delenv(name, raising=False)
    for name, value in env.items():
        monkeypatch.setenv(name, value)
    assert cohort._rank_nprocs() == want
