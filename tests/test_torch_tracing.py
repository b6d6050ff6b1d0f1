"""The port's spans (``utils.profiling.Tracer``) on the CPU.

A tiny ``run`` through the command line writes ``spans`` into its
``metrics.json``: one run identifier, children inside their parents, the
top-level spans over the command's wall, the frontend's parts over the
frontend, and ``stages`` as before.  Under ``DEFUSE_TORCH_PROFILE`` every span is a
``defuse:`` host range of the run's trace; with no profiler recording no
profiler record is entered.  Breakseq's per-target calls write the files
of one call over every target, each span with the counts of its pass.
Every span carries the process's resident high-water mark at its exit and
its rise over the span; a process's start spans land once, in its first
``metrics.json`` (these run in fresh processes, whose marks no earlier
test has raised)."""

import json
import os
import pathlib
import subprocess
import sys
import time

import pytest
import torch

from defuse_tpu_torch.cli import main as port_cli
from defuse_tpu_torch.utils import profiling, synth

from synthdata import make_dataset, write_dataset

REPO = pathlib.Path(__file__).resolve().parent.parent
MB = 10 ** 6
RUN_STAGES = ["discover", "pvalues", "breakseq", "annotation", "denovo",
              "collate+classify"]
FRONTEND = ("frontend.ingest", "frontend.index_load", "frontend.align_job")


@pytest.fixture(scope="module")
def library(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("torch_tracing")
    ds = make_dataset(seed=11, n_fusion_frags=80, n_background_frags=40)
    paths = write_dataset(ds, tmp / "data")
    config = synth.write_run_config(ds, tmp / "refs")
    assert port_cli.main(["create-ref", "-c", str(config), "-d",
                          str(tmp / "dataset")]) == 0
    return tmp, ["-c", str(config), "-d", str(tmp / "dataset"), "-1",
                 str(paths["fastq1"]), "-2", str(paths["fastq2"]),
                 "--device", "cpu"]


def run(args, out):
    """``run`` into ``out``; its ``metrics.json`` and the command's wall
    on ``perf_counter_ns``."""
    t0 = time.perf_counter_ns()
    assert port_cli.main(["run", "-o", str(out)] + args) == 0
    t1 = time.perf_counter_ns()
    return json.loads((out / "metrics.json").read_text()), t0, t1


@pytest.fixture(scope="module")
def traced(library):
    """A run in a process that has run once: the first run's imports are
    the process's start, before the command's first span."""
    tmp, args = library
    run(args, tmp / "warm")
    return run(args, tmp / "run")


def without_marks(counts):
    """A span's counts less the resident high-water mark at its exit and
    its rise over the span, which every span carries."""
    rest = dict(counts)
    assert rest.pop("rss_hwm") > 0 and rest.pop("rss_hwm_rise") >= 0
    return rest


def covered(intervals):
    total, reach = 0, None
    for a, b in sorted(intervals):
        a = a if reach is None else max(a, reach)
        if b > a:
            total += b - a
            reach = b
    return total


def test_run_writes_spans_on_one_clock(traced):
    metrics, t0, t1 = traced
    spans = metrics["spans"]
    names = [s["name"] for s in spans]
    for name in ("frontend", *FRONTEND, "frontend.index_load.cdna",
                 "frontend.index_load.genome", "frontend.index_load.rrna",
                 "read stats", "covariance samples", "discover",
                 "discover:cluster", "discover:evaluate", "pvalues",
                 "breakseq", "breakseq.index_load", "breakseq.align.genome",
                 "breakseq.align.cdna", "annotation", "denovo",
                 "collate+classify"):
        assert name in names, name
    assert len({s["run"] for s in spans}) == 1
    assert len({s["id"] for s in spans}) == len(spans)
    for s in spans:
        assert t0 <= s["start_ns"] <= s["end_ns"] <= t1, s
        assert 0 <= s["self_seconds"] <= s["seconds"] + 1e-6
    top = [(s["start_ns"], s["end_ns"]) for s in spans
           if s["parent"] is None]
    assert covered(top) >= 0.95 * (t1 - t0)


def test_stages_keep_their_names_and_order(traced):
    metrics, _t0, _t1 = traced
    assert list(metrics)[:3] == ["total_seconds", "stages", "counters"]
    assert [s["stage"] for s in metrics["stages"]] == RUN_STAGES
    by_name = {s["name"]: s for s in metrics["spans"]}
    for stage in metrics["stages"]:
        assert stage["seconds"] == pytest.approx(
            by_name[stage["stage"]]["seconds"], abs=1e-4)
    assert metrics["total_seconds"] == pytest.approx(
        sum(s["seconds"] for s in metrics["stages"]), abs=1e-3)


def test_children_nest_within_their_parents(traced):
    metrics, _t0, _t1 = traced
    by_id = {s["id"]: s for s in metrics["spans"]}
    for s in metrics["spans"]:
        if s["parent"] is None:
            continue
        p = by_id[s["parent"]]
        assert p["start_ns"] <= s["start_ns"] <= s["end_ns"] <= p["end_ns"]
    kids = {}
    for s in metrics["spans"]:
        kids.setdefault(by_id[s["parent"]]["name"] if s["parent"] is not None
                        else None, set()).add(s["name"])
    assert kids["frontend"] == set(FRONTEND)
    assert "frontend.align_job" not in kids
    assert "discover:cluster" in kids["discover"]
    assert kids["breakseq"] == {"breakseq.index_load"} | {
        f"breakseq.align.{t}" for t in ("genome", "cdna", "exons", "cds")}


def test_frontend_children_cover_the_frontend(traced):
    metrics, _t0, _t1 = traced
    (front,) = [s for s in metrics["spans"] if s["name"] == "frontend"]
    kids = [(s["start_ns"], s["end_ns"]) for s in metrics["spans"]
            if s["parent"] == front["id"]]
    assert covered(kids) >= 0.9 * (front["end_ns"] - front["start_ns"])
    counts = {s["name"]: s["counts"] for s in metrics["spans"]}
    assert counts["frontend.ingest"]["pairs"] == 120
    assert counts["frontend.ingest"]["bytes"] > 0
    assert counts["frontend.index_load.genome"]["bytes"] > 0


def test_align_job_is_one_span_a_shard(traced):
    """One shard here (120 pairs, under ``reads_per_job``): one
    ``align_job`` span inside the frontend, after the ingest and the index
    loads, counting the shard's pairs."""
    metrics, _t0, _t1 = traced
    by_name = {s["name"]: s for s in metrics["spans"]}
    (job,) = [s for s in metrics["spans"]
              if s["name"] == "frontend.align_job"]
    assert job["parent"] == by_name["frontend"]["id"]
    assert without_marks(job["counts"]) == {"pairs": 120}
    assert job["start_ns"] >= by_name["frontend.index_load"]["end_ns"] >= \
        by_name["frontend.ingest"]["end_ns"]
    assert job["self_seconds"] == job["seconds"] > 0


def test_run_spans_keep_each_finished_run(library, tmp_path):
    _tmp, args = library
    before = len(profiling.RUN_SPANS)
    metrics, _t0, _t1 = run(args, tmp_path / "again")
    assert len(profiling.RUN_SPANS) == before + 1
    last = profiling.RUN_SPANS[-1]
    assert set(last) == {s["name"] for s in metrics["spans"]}
    assert last["breakseq"] == pytest.approx(
        {s["stage"]: s["seconds"] for s in metrics["stages"]}["breakseq"],
        abs=1e-4)


def test_whole_run_profile_has_a_range_for_every_span(library, tmp_path,
                                                      monkeypatch):
    _tmp, args = library
    monkeypatch.setenv("DEFUSE_TORCH_PROFILE", str(tmp_path / "prof"))
    metrics, _t0, _t1 = run(args, tmp_path / "profiled")
    (trace_dir,) = (tmp_path / "prof").iterdir()
    assert trace_dir.name == metrics["spans"][0]["run"]
    assert (trace_dir / "kernels.txt").stat().st_size > 0
    events = json.loads((trace_dir / "trace.json").read_text())["traceEvents"]
    ranges = sorted(e["name"] for e in events
                    if e.get("cat") == "cpu_op"
                    and e["name"].startswith(profiling.SPAN_PREFIX))
    assert ranges == sorted(profiling.SPAN_PREFIX + s["name"]
                            for s in metrics["spans"])


def test_spans_are_host_ranges_of_a_recording_profiler():
    """Host events of the profiler's, none on a device's timeline."""
    tracer = profiling.Tracer()
    acts = [torch.profiler.ProfilerActivity.CPU]
    with torch.profiler.profile(activities=acts) as prof:
        with tracer.span("outer"):
            tracer.stage("first")
            tracer.stage(None)
    spans = [e for e in prof.events() if e.name.startswith("defuse:")]
    assert sorted(e.name for e in spans) == ["defuse:first", "defuse:outer"]
    assert {e.device_type for e in spans} == {
        torch.autograd.DeviceType.CPU}


def test_no_record_function_while_the_profiler_is_off(monkeypatch):
    entered = []
    monkeypatch.setattr(torch._C._profiler, "_RecordFunctionFast",
                        lambda name: entered.append(name))
    monkeypatch.setattr(torch.profiler, "record_function",
                        lambda name: entered.append(name))
    tracer = profiling.Tracer()
    with tracer.span("a", n=1) as counts:
        counts["m"] = 2
        tracer.stage("b")
        tracer.stage(None)
    assert entered == []
    assert [r[1] for r in tracer.spans] == ["b", "a"]
    assert without_marks(tracer.spans[1][5]) == {"n": 1, "m": 2}


def test_stage_timing_echo_prints_each_span(monkeypatch, capsys, tmp_path):
    monkeypatch.setenv("DEFUSE_STAGE_TIMING", "1")
    tracer = profiling.Tracer(str(tmp_path))
    part = tracer.part(str(tmp_path), "metrics.part.json")
    with tracer.span("outer"):
        part.stage("discover:cluster")
        part.stage(None)
    with tracer.span("late"):
        pass
    out = capsys.readouterr().out.splitlines()
    assert out[0].startswith("[stage] discover:cluster: ")
    assert out[1].startswith("[stage] outer: ")
    assert out[2].startswith("[stage] late: ")
    part.flush()
    written = json.loads((tmp_path / "metrics.part.json").read_text())
    assert list(written) == ["total_seconds", "stages", "counters"]
    assert [s["stage"] for s in written["stages"]] == ["discover:cluster"]


def test_self_seconds_leave_out_what_children_cover():
    tracer = profiling.Tracer()
    ms = 1_000_000
    tracer.spans[:] = [[1, "kid", 0, 10 * ms, 40 * ms, {}],
                       [2, "kid", 0, 30 * ms, 60 * ms, {}],
                       [0, "top", None, 0, 100 * ms, {}]]
    recs = {r["id"]: r for r in tracer.span_records()}
    assert recs[0]["self_seconds"] == pytest.approx(0.05)
    assert recs[1]["self_seconds"] == recs[1]["seconds"] == 0.03
    assert [r["id"] for r in tracer.span_records()] == [0, 1, 2]
    assert tracer.span_seconds() == pytest.approx({"kid": 0.06,
                                                   "top": 0.1})


def test_failed_run_closes_its_spans_and_writes_nothing(tmp_path):
    before = len(profiling.RUN_SPANS)
    with pytest.raises(ValueError):
        with profiling.library(str(tmp_path)) as tracer:
            assert profiling.current() is tracer
            tracer.stage("discover")
            with tracer.span("inner"):
                raise ValueError("stop")
    assert not tracer._open
    assert profiling.current() is not tracer
    assert not (tmp_path / "metrics.json").exists()
    assert len(profiling.RUN_SPANS) == before


def test_library_is_opened_once_for_one_output(tmp_path):
    with profiling.library(str(tmp_path)) as outer:
        with profiling.library(str(tmp_path)) as inner:
            assert inner is outer
        with profiling.library(str(tmp_path / "other")) as other:
            assert other is not outer and profiling.current() is other
        assert profiling.current() is outer
    assert (tmp_path / "metrics.json").exists()
    assert (tmp_path / "other" / "metrics.json").exists()


def test_breakseq_target_spans_count_their_pass(traced, library):
    """Each ``breakseq.align.<target>`` span carries what its batched pass
    carried: the queries (the non-``N`` rows of ``splitreads.seq``), the
    seeds searched, their hits, the blocks and the PSL rows written."""
    metrics, _t0, _t1 = traced
    tmp, _args = library
    queries = sum(1 for line in open(tmp / "run" / "splitreads.seq")
                  if line.split("\t")[1] not in ("N", ""))
    assert queries > 0
    spans = [s for s in metrics["spans"]
             if s["name"].startswith("breakseq.align.")]
    assert len(spans) == 4
    for s in spans:
        counts = s["counts"]
        assert sorted(without_marks(counts)) == [
            "blocks", "hits", "queries", "rows", "seeds"], s["name"]
        assert counts["queries"] == queries
        assert counts["seeds"] >= queries
        assert counts["hits"] >= counts["blocks"] > 0
        labels = ["genome", "genome.nointron"] \
            if s["name"] == "breakseq.align.genome" else [s["name"][15:]]
        assert counts["rows"] == sum(
            len((tmp / "run" / f"breakpoints.{label}.psl").read_text()
                .splitlines()) for label in labels)


def test_breakseq_per_target_writes_the_files_of_one_call(tmp_path):
    """``pipeline.run`` aligns breakseq a target at a time: the same
    ``breakpoints.*.psl`` bytes as one ``align_breakpoints`` call."""
    import random

    from defuse_tpu_torch.align.breakseq import align_breakpoints
    from defuse_tpu_torch.align.seedindex import SeedIndex

    rng = random.Random(5)

    def seq(n):
        return "".join(rng.choice("ACGT") for _ in range(n))

    genome = {"1": seq(6000), "2": seq(6000)}
    cdna = {"GA|T1": genome["1"][1000:2500], "GB|T2": genome["2"][500:2000]}
    exons = {"GA|T1|e1": genome["1"][1000:1600]}
    seqs = {}
    for cid in range(6):
        a = rng.randrange(1000, 2400)
        b = rng.randrange(500, 1900)
        seqs[cid] = genome["1"][a - 60:a] + "|" + genome["2"][b:b + 60]
    seqs[6] = "N"
    targets = {"genome": SeedIndex(genome), "cdna": SeedIndex(cdna),
               "exons": SeedIndex(exons)}
    (tmp_path / "one").mkdir()
    (tmp_path / "each").mkdir()
    whole = align_breakpoints(seqs, targets, str(tmp_path / "one"))
    each = {}
    for name, index in targets.items():
        each.update(align_breakpoints(seqs, {name: index},
                                      str(tmp_path / "each")))
    assert sorted(whole) == sorted(each) == sorted(
        ["genome", "genome.nointron", "cdna", "exons"])
    for label in whole:
        one = pathlib.Path(whole[label]).read_bytes()
        assert one == pathlib.Path(each[label]).read_bytes(), label
    assert pathlib.Path(whole["genome"]).stat().st_size > 0


def in_fresh_process(code: str, *args: str) -> str:
    """The last line of what ``code`` prints, run by a new interpreter from
    the repository's root.  Linux carries a process's resident high-water
    mark across ``exec``, and a child of this process would start at this
    process's mark: the interpreter is a child of ``sh``, which starts at
    its own."""
    env = os.environ | {"PYTHONPATH": str(REPO)}
    proc = subprocess.run(["sh", "-c", '"$@"; exit $?', "sh",
                           sys.executable, "-c", code, *args], cwd=REPO,
                          env=env, capture_output=True, text=True,
                          timeout=300)
    assert proc.returncode == 0, proc.stderr[-3000:]
    return proc.stdout.strip().splitlines()[-1]


SPANS_IN_A_FRESH_PROCESS = """
import json
import numpy as np
from defuse_tpu_torch.utils import profiling
tracer = profiling.Tracer()
with tracer.span("outer"):
    with tracer.span("big", n=1):
        block = np.ones(256 * 2 ** 20 // 8)
    with tracer.span("empty"):
        pass
print(json.dumps({r["name"]: r["counts"] for r in tracer.span_records()}))
"""


@pytest.fixture(scope="module")
def marked():
    return json.loads(in_fresh_process(SPANS_IN_A_FRESH_PROCESS))


def test_span_records_the_rise_of_the_mark(marked):
    """256 MiB of new NumPy memory raise the mark by over 240 MB in their
    span; an empty span raises it by under 8 MB."""
    assert marked["big"]["rss_hwm_rise"] >= 240 * MB
    assert 0 <= marked["empty"]["rss_hwm_rise"] < 8 * MB
    assert marked["empty"]["rss_hwm"] >= marked["big"]["rss_hwm"]


def test_nested_spans_carry_their_own_counts(marked):
    outer, big, empty = marked["outer"], marked["big"], marked["empty"]
    assert big["n"] == 1 and "n" not in outer and "n" not in empty
    assert outer["rss_hwm"] == empty["rss_hwm"]
    assert outer["rss_hwm_rise"] >= big["rss_hwm_rise"] + \
        empty["rss_hwm_rise"]
    assert outer["rss_hwm_rise"] - big["rss_hwm_rise"] < 8 * MB


TWO_RUNS_IN_A_FRESH_PROCESS = """
import json, sys
from defuse_tpu_torch.cli import main as cli
from defuse_tpu_torch.utils import profiling
args = json.loads(sys.argv[1])
for out in sys.argv[2:]:
    assert cli.main(["run", "-o", out] + args) == 0
print(json.dumps(list(profiling.RUN_MEMORY)))
"""


@pytest.fixture(scope="module")
def two_runs(library):
    """Two ``run``s of the library on the CPU in one fresh process: their
    ``metrics.json`` and the process's ``RUN_MEMORY``."""
    tmp, args = library
    outs = [tmp / "fresh_first", tmp / "fresh_second"]
    memory = json.loads(in_fresh_process(
        TWO_RUNS_IN_A_FRESH_PROCESS, json.dumps(args), *map(str, outs)))
    return [json.loads((o / "metrics.json").read_text()) for o in outs], \
        memory


def test_process_start_spans_land_once_in_the_first_metrics(two_runs):
    (first, second), _memory = two_runs
    spans = first["process_spans"]
    names = [s["name"] for s in spans]
    assert len(set(names)) == len(names)
    assert names[0] == "process.import" and "process.native_load" in names
    assert "process_spans" not in second
    imported = spans[0]["counts"]
    assert imported["torch_preloaded"] == 0
    assert imported["rss_hwm"] >= imported["rss_hwm_rise"] > 0
    for span in spans[1:]:       # inside the run, on the spans' clock
        assert first["spans"][0]["start_ns"] <= span["start_ns"] <= \
            span["end_ns"] <= first["spans"][-1]["end_ns"]
        assert span["counts"]["rss_hwm"] >= span["counts"]["rss_hwm_rise"]


def test_cpu_process_makes_no_cuda_context(two_runs):
    (first, _second), _memory = two_runs
    names = [s["name"] for s in first["process_spans"]]
    assert not any(n == "process.cuda_context" or
                   n.startswith("process.bind.") for n in names)


def test_require_cuda_only_checks_and_cpu_makes_no_context():
    """``require_cuda`` makes no context and records nothing, whatever it
    answers; ``start_context`` leaves a CPU device alone."""
    import torch
    from defuse_tpu_torch.core import devices
    before = list(profiling.PROCESS_SPANS)
    cpu = devices.start_context(devices.require_cuda("cpu"))
    assert cpu == torch.device("cpu")
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="is_available"):
            devices.require_cuda("cuda")
    assert profiling.PROCESS_SPANS == before
    assert "process.cuda_context" not in [
        s["name"] for s in profiling.PROCESS_SPANS]


def test_each_run_leaves_its_memory_record(two_runs):
    """A run's ``memory``: the mark at its entry and exit, and the rise of
    each span name, as ``RUN_MEMORY`` keeps it."""
    (first, second), memory = two_runs
    assert memory == [first["memory"], second["memory"]]
    for metrics in (first, second):
        record = metrics["memory"]
        start, end = record["start"], record["end"]
        assert start == {"rss_hwm": start["rss_hwm"]}
        assert 0 < start["rss_hwm"] <= end["rss_hwm"]
        rises = {}
        for span in metrics["spans"]:
            rises[span["name"]] = rises.get(span["name"], 0) + \
                span["counts"]["rss_hwm_rise"]
        assert record["rise"] == rises
        top = sum(s["counts"]["rss_hwm_rise"] for s in metrics["spans"]
                  if s["parent"] is None)
        assert top <= end["rss_hwm"] - start["rss_hwm"]
    assert second["memory"]["start"]["rss_hwm"] >= \
        first["memory"]["end"]["rss_hwm"]
