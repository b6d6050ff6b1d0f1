"""The readers of the program's own spans (``frontend_s``, ``ingest_s``,
``index_load_s``, ``align_job_s``) read the window's last runs in
``profiling.RUN_SPANS`` and nothing where those records are short; those
of its stages (``breakseq_s``, ``annotation_s``) read the window's
libraries' ``stages``; a tiny traced cell on CPU tensors prints all six,
``frontend_s`` the mean of the window's ``frontend`` spans."""

import collections
import types

import pytest

import run
from defuse_tpu_torch.utils import profiling

READERS = {
    "frontend_s": ("frontend",),
    "ingest_s": ("frontend.ingest",),
    "index_load_s": ("frontend.index_load", "breakseq.index_load"),
    "align_job_s": ("frontend.align_job",),
}
STAGE_READERS = {"breakseq_s": "breakseq", "annotation_s": "annotation"}


def record(k):
    """One run's span seconds: span ``i`` of ``READERS``' names reads
    ``k + i / 10``, beside spans the readers leave alone."""
    names = sorted({n for spans in READERS.values() for n in spans})
    return {n: k + i / 10 for i, n in enumerate(names)} | {
        "breakseq": 50.0, "annotation": 60.0}


@pytest.fixture
def spans(monkeypatch):
    """``RUN_SPANS`` holding the warm-up's record and two window runs."""
    runs = collections.deque([record(100), record(1), record(3)],
                             maxlen=profiling.RUN_SPANS.maxlen)
    monkeypatch.setattr(profiling, "RUN_SPANS", runs)
    return runs


def context(n_libraries):
    """The window's libraries: library ``k``'s stage ``i`` of
    ``STAGE_READERS`` reads ``k + i / 10``."""
    stages = sorted(STAGE_READERS.values())
    return types.SimpleNamespace(libraries=[
        {"stages": {s: k + i / 10 for i, s in enumerate(stages)}
         | {"discover": 9.0}} for k in range(n_libraries)], trace=None)


@pytest.mark.parametrize("name", sorted(READERS))
def test_reader_means_the_window_runs(spans, name):
    want = sum(sum(r[n] for n in READERS[name]) for r in list(spans)[1:]) / 2
    assert run.reader(run.ROOT, name)(context(2)) == pytest.approx(want)


@pytest.mark.parametrize("name", sorted(READERS))
def test_reader_reads_nothing_from_short_records(spans, name):
    assert run.reader(run.ROOT, name)(context(4)) is None
    assert run.reader(run.ROOT, name)(context(0)) is None
    spans.clear()
    assert run.reader(run.ROOT, name)(context(1)) is None


@pytest.mark.parametrize("name", sorted(READERS))
def test_reader_reads_nothing_without_the_span(monkeypatch, name):
    monkeypatch.setattr(profiling, "RUN_SPANS",
                        collections.deque([{"discover": 1.0}] * 3))
    assert run.reader(run.ROOT, name)(context(2)) is None


@pytest.mark.parametrize("name", sorted(READERS))
def test_reader_reads_nothing_from_a_program_without_spans(monkeypatch,
                                                           name):
    monkeypatch.delattr(profiling, "RUN_SPANS")
    assert run.reader(run.ROOT, name)(context(2)) is None


def stage_mean(name, n_libraries):
    libs = context(n_libraries).libraries
    return sum(r["stages"][STAGE_READERS[name]] for r in libs) / len(libs)


@pytest.mark.parametrize("name", sorted(STAGE_READERS))
def test_stage_reader_means_the_window_libraries(name):
    assert run.reader(run.ROOT, name)(context(3)) == \
        pytest.approx(stage_mean(name, 3))


@pytest.mark.parametrize("name", sorted(STAGE_READERS))
def test_stage_reader_reads_nothing_without_libraries(name):
    assert run.reader(run.ROOT, name)(context(0)) is None


@pytest.mark.parametrize("name", sorted(STAGE_READERS))
def test_stage_reader_reads_the_stages_not_the_spans(spans, name):
    assert run.reader(run.ROOT, name)(context(2)) == \
        pytest.approx(stage_mean(name, 2))


@pytest.mark.parametrize("name", sorted(STAGE_READERS))
def test_stage_reader_reads_a_program_without_spans(monkeypatch, name):
    monkeypatch.delattr(profiling, "RUN_SPANS")
    assert run.reader(run.ROOT, name)(context(2)) == \
        pytest.approx(stage_mean(name, 2))


def test_traced_tiny_cell_prints_the_span_metrics(tiny_tree, capsys):
    from test_fb_end_to_end import result
    traced = result(tiny_tree, capsys, trace=1)
    assert traced["correct"] is True
    for name in [*READERS, *STAGE_READERS]:
        assert traced["metrics"][name]["value"] > 0, name
        assert traced["metrics"][name]["unit"] == "s"
    window = list(profiling.RUN_SPANS)[-traced["attempted"]:]
    assert traced["failed"] == 0
    assert traced["metrics"]["frontend_s"]["value"] == pytest.approx(
        sum(r["frontend"] for r in window) / len(window), rel=1e-12)
