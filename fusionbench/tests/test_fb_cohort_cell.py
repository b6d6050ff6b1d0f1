"""The cell ``wts50.cohort`` (``wts50``'s libraries through ``defuse
cohort``, 8 a call, 4 library processes at once) found from its files, and
the readers of the cohort's spans, ``library_spawn_s`` and
``cohort_wait_s``, on a recorded library."""

import json
import types

import pytest

import cohort
import run
from conftest import BENCH, ROOT


def test_cohort_cell_found_from_its_files():
    """``wts50.cohort``: ``wts50``'s libraries through ``defuse cohort``,
    8 a call, 4 at once on one card, with the two metrics of the cohort's
    spans read in it alone."""
    cell = run.Cell("wts50.cohort", ROOT)
    assert (cell.verb, cell.n_libraries, cell.workers, cell.chips) == \
        ("cohort", 8, 4, 1)
    assert cell.mix["name"] == "dense" and cell.screen == "device"
    wts50 = json.loads((BENCH / "configs" / "wts50.json").read_text())
    for key in ("read_length", "fragment", "library_pairs", "genome",
                "reduced", "guarantees", "defuse", "sizes"):
        assert cell.cfg[key] == wts50[key], key
    assert set(cell.cfg["assumed"]) == set(wts50["assumed"]) | {
        "libraries", "workers"}
    new = {"library_spawn_s", "cohort_wait_s"}
    assert new <= set(cell.per_layer)
    assert set(cell.end_to_end) == {"peak_rss_gib", "setup_s"}
    for other in ("wts50.dense", "wts101.dense"):
        assert not new & set(run.Cell(other, ROOT).per_layer)
    for name in new:
        assert run.reader(ROOT, name)


def test_cohort_span_readers_on_a_recorded_library(tmp_path):
    """``library_spawn_s`` and ``cohort_wait_s`` are the means of a cohort
    library's ``cohort.spawn`` and ``cohort.wait`` spans, from the record
    the harness reads; a library without them (a program whose cohort
    records no such spans) reads nothing."""
    spans = [("cohort.wait", 0.0, 12.0), ("cohort.spawn", 12.0, 16.5),
             ("frontend", 17.0, 18.0)]
    records = []
    for k, shift in enumerate((0.0, -12.0)):     # the second waited none
        lib = tmp_path / f"lib{k}"
        lib.mkdir()
        (lib / "metrics.json").write_text(json.dumps({
            "stages": [{"stage": "discover", "seconds": 1.0}],
            "counters": {"cohort_workers": 4, "cpus": 8,
                         "torch_threads": 8},
            "spans": [{"name": n, "run": f"r{k}",
                       "start_ns": int(max(a + shift, 0) * 1e9),
                       "end_ns": int(max(b + shift, 0) * 1e9)}
                      for n, a, b in spans]}))
        (lib / "metrics.discover.json").write_text(json.dumps({
            "total_seconds": 1.0, "counters": {}}))
        records.append(cohort.library_record(lib))
    ctx = types.SimpleNamespace(libraries=records, trace=None)
    assert run.reader(run.ROOT, "cohort_wait_s")(ctx) == pytest.approx(6.0)
    assert run.reader(run.ROOT, "library_spawn_s")(ctx) == \
        pytest.approx(4.5)
    for rec in records:
        del rec["spans"]["cohort.wait"], rec["spans"]["cohort.spawn"]
    for name in ("cohort_wait_s", "library_spawn_s"):
        assert run.reader(run.ROOT, name)(ctx) is None, name
