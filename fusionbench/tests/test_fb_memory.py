"""The readers of the program's memory records (``program_memory.py``):
the marks of the process's start from ``profiling.PROCESS_SPANS``, and the
window's first mark and each layer's rise from the window's last runs in
``profiling.RUN_MEMORY``; nothing in a cohort cell, from short records or
from a program without them; a tiny traced cell on CPU tensors, whose
first mark and rises add up to the harness's end mark."""

import collections
import re
import types

import pytest

import run
from defuse_tpu_torch.utils import profiling

GIB = 2 ** 30
MIB = 2 ** 20
READERS = ("import_rss_gib", "cuda_start_rss_gib", "start_rss_gib",
           "frontend_rss_rise_gib", "discover_rss_rise_gib",
           "run_stages_rss_rise_gib")
RUN_STAGES = ("read stats", "covariance samples", "pvalues", "breakseq",
              "annotation", "denovo", "collate+classify")


def process_spans():
    def span(name, mark, rise):
        return {"name": name, "counts": {"rss_hwm": mark,
                                         "rss_hwm_rise": rise}}
    return [span("process.import", 700 * MIB, 600 * MIB),
            span("process.cuda_context", 4 * GIB, 3 * GIB),
            span("process.native_load", 4 * GIB + MIB, MIB),
            span("process.bind.split_dp", 4 * GIB + 5 * MIB, 4 * MIB),
            span("process.bind.em", 4 * GIB + 7 * MIB, 2 * MIB)]


def memory(k):
    """Run ``k``'s record: it starts at ``6 + k`` GiB, and the span of
    ``RUN_STAGES`` ``i`` rises by ``i + 1`` MiB, the frontend by ``10 + k``
    and discover by ``20 + k``, beside a child of the frontend's."""
    rise = {name: (i + 1) * MIB for i, name in enumerate(RUN_STAGES)}
    rise |= {"frontend": (10 + k) * MIB, "frontend.align_job": 9 * MIB,
             "discover": (20 + k) * MIB}
    return {"start": {"rss_hwm": (6 + k) * GIB}, "end": {}, "rise": rise}


@pytest.fixture
def records(monkeypatch):
    """The warm-up's record and two window runs'."""
    runs = collections.deque([memory(10), memory(1), memory(2)],
                             maxlen=profiling.RUN_MEMORY.maxlen)
    monkeypatch.setattr(profiling, "RUN_MEMORY", runs)
    monkeypatch.setattr(profiling, "PROCESS_SPANS", process_spans())
    return runs


def context(n_libraries, cohort=False):
    extra = {"spans": {"frontend": 1.0}} if cohort else {}
    return types.SimpleNamespace(libraries=[
        {"stages": {}, **extra} for _ in range(n_libraries)], trace=None)


def read(name, ctx):
    return run.reader(run.ROOT, name)(ctx)


def test_readers_give_their_values(records):
    ctx = context(2)
    assert read("import_rss_gib", ctx) == pytest.approx(700 / 1024)
    assert read("cuda_start_rss_gib", ctx) == pytest.approx(
        3 + 6 / 1024)
    assert read("start_rss_gib", ctx) == pytest.approx(7)
    assert read("frontend_rss_rise_gib", ctx) == pytest.approx(23 / 1024)
    assert read("discover_rss_rise_gib", ctx) == pytest.approx(43 / 1024)
    assert read("run_stages_rss_rise_gib", ctx) == pytest.approx(
        2 * sum(range(1, 8)) / 1024)


@pytest.mark.parametrize("name", READERS)
def test_reader_reads_nothing_in_a_cohort_cell(records, name):
    assert read(name, context(2, cohort=True)) is None


@pytest.mark.parametrize("name", READERS)
def test_reader_reads_nothing_from_a_program_without_records(monkeypatch,
                                                             name):
    monkeypatch.delattr(profiling, "RUN_MEMORY")
    monkeypatch.delattr(profiling, "PROCESS_SPANS")
    assert read(name, context(2)) is None


@pytest.mark.parametrize("name", READERS[2:])
def test_window_reader_reads_nothing_from_short_records(records, name):
    assert read(name, context(4)) is None
    assert read(name, context(0)) is None


@pytest.mark.parametrize("name", READERS[3:])
def test_rise_reader_reads_nothing_without_the_span(monkeypatch, name):
    monkeypatch.setattr(profiling, "RUN_MEMORY", collections.deque(
        [{"start": {"rss_hwm": GIB}, "rise": {"other": MIB}}] * 3))
    assert read(name, context(2)) is None


def test_start_readers_read_nothing_without_their_spans(monkeypatch):
    monkeypatch.setattr(profiling, "PROCESS_SPANS", process_spans()[2:3])
    assert read("import_rss_gib", context(2)) is None
    assert read("cuda_start_rss_gib", context(2)) is None


def test_traced_tiny_cell_adds_up_to_the_end_mark(tiny_tree, capsys):
    """The window's first mark plus the layers' rises lies at or under the
    harness's end mark, within 0.05 GiB of it; the first mark at or over
    its start mark, within the same."""
    bench = run.json.loads((tiny_tree / "BENCHMARK.json").read_text())
    for metric in bench["per_layer"]:
        if metric["name"] in READERS:
            metric["workloads"].append("tiny.few")
    (tiny_tree / "BENCHMARK.json").write_text(run.json.dumps(bench))
    out = run.main(["--workload", "tiny.few", "--seed", str(2 ** 31 + 91),
                    "--seconds", "1", "--trace", "1"], require_card=False,
                   device="cpu", root=tiny_tree, cache=tiny_tree / "cache")
    assert out == 0
    captured = capsys.readouterr()
    res = run.json.loads(captured.out.strip().splitlines()[-1])
    assert res["correct"] is True and res["failed"] == 0
    window = re.search(r"\[window\] .* mark (\d+) bytes at the start, "
                       r"(\d+) at the end", captured.err)
    start, end = int(window[1]) / GIB, int(window[2]) / GIB
    got = {k: v["value"] for k, v in res["metrics"].items()}
    assert "cuda_start_rss_gib" not in got      # no card, no context
    assert 0 < got["import_rss_gib"] <= got["start_rss_gib"]
    assert start <= got["start_rss_gib"] <= start + 0.05
    total = got["start_rss_gib"] + sum(
        got[f"{layer}_rss_rise_gib"]
        for layer in ("frontend", "discover", "run_stages"))
    assert end - 0.05 <= total <= end
    for name in READERS[2:]:
        assert res["metrics"][name]["unit"] == "GiB"
