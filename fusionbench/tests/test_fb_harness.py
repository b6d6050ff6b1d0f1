"""The harness's data-driven parts: files found by name, the metric
readers on a recorded fixture, the screen's work from shapes, the device
trace's reduction and the import check."""

import json
import sys
import types

import pytest

import devtrace
import roofline
import run
from conftest import HERE


def fixture_context():
    rec = json.loads((HERE / "fixtures" / "context.json").read_text())
    events = [tuple(e) for e in rec["events"]]
    win = [(s, e) for n, d, s, e in events if n == "fusionbench:window"][0]
    screen = types.SimpleNamespace(cells=rec["screen_cells"])
    return run.Context(rec["libraries"], devtrace.analyse(events, win),
                       screen, rec["peak_ops"])


def test_files_found_by_name(tiny_tree):
    cell = run.Cell("tiny.few", tiny_tree)
    assert cell.cfg["name"] == "tiny" and cell.mix["fusions"] == 50
    assert set(cell.per_layer) >= {"frontend_s", "device_idle_pct"}
    metrics = tiny_tree / "fusionbench" / "metrics"
    metrics.mkdir()
    (metrics / "libraries_read.py").write_text(
        "def read(ctx):\n    return float(len(ctx.libraries))\n")
    assert run.reader(tiny_tree, "libraries_read")(fixture_context()) == 2.0
    # the benchmark's own readers are found from any tree
    assert run.reader(tiny_tree, "frontend_s")(fixture_context()) == \
        pytest.approx(1.1)
    with pytest.raises(SystemExit):
        run.Cell("no.such", tiny_tree)


def test_readers_on_recorded_fixture():
    ctx = fixture_context()
    got = {n: run.reader(run.ROOT, n)(ctx) for n in (
        "frontend_s", "discover_s", "run_stages_s", "device_idle_pct",
        "screen_roofline_pct")}
    assert got["frontend_s"] == pytest.approx(1.1)
    assert got["discover_s"] == pytest.approx(0.7)
    assert got["run_stages_s"] == pytest.approx(1.4)
    # busy: the copy 400 us and the two kernels' union 300 us of 10 s
    assert ctx.trace.busy_s == pytest.approx(700e-6)
    assert got["device_idle_pct"] == pytest.approx(100 * (1 - 70e-6))
    # 1e9 cells x 3 operations over 3.3792e13 op/s, in 400 us of kernels
    assert got["screen_roofline_pct"] == pytest.approx(
        100 * 3e9 / 3.3792e13 / 400e-6)
    # the longest idle stretch lies in a library where no program range
    # is open; the program's ranges name the rest of the libraries
    names = [n for n, _ in ctx.trace.gaps]
    assert names[0] == "fusionbench:library" and set(names) == {
        "defuse:frontend", "defuse:discover", "fusionbench:library",
        "between"}
    assert sum(s for _, s in ctx.trace.gaps) == pytest.approx(
        10 - 700e-6)


def test_reader_finds_nothing_to_read():
    ctx = fixture_context()
    ctx.screen = types.SimpleNamespace(cells=0)
    assert run.reader(run.ROOT, "screen_roofline_pct")(ctx) is None
    ctx.trace = None
    assert run.reader(run.ROOT, "device_idle_pct")(ctx) is None


def test_screen_cells_from_shapes():
    ulen1, ulen2 = [100, 50, 0], [20, 30, 7]
    ref_idx, read_lens = [0, 1, 1, 2], [50, 40, 50, 10]
    want = 50 * 120 + 40 * 80 + 50 * 80 + 10 * 7
    assert roofline.screen_cells(ulen1, ulen2, ref_idx, read_lens) == want
    assert roofline.int_peak_ops(132, 1.98e9) == 132 * 64 * 2 * 1.98e9


@pytest.mark.parametrize("name, flagged", [
    ("defuse_tpu_torch.cli", False), ("defuse_tpu", True),
    ("defuse_tpu.ops.split_dp", True), ("jaxlib.xla_client", True),
    ("jax", True), ("flax.linen", True), ("jaxtyping", False),
    ("defuse_tpu_extra", False)])
def test_import_check_compares_whole_names(monkeypatch, name, flagged):
    monkeypatch.setitem(sys.modules, name, types.ModuleType(name))
    assert (name.split(".")[0] in run.forbidden_modules()) == flagged


def test_benchmark_names_its_metrics_readers():
    bench = json.loads((run.ROOT / "BENCHMARK.json").read_text())
    for m in bench["per_layer"]:
        assert callable(run.reader(run.ROOT, m["name"]))
    for c in bench["configs"]:
        assert (run.ROOT / c["file"]).exists()
    for w in bench["workloads"]:
        assert (run.HERE / "traffic" / f"{w['traffic']}.json").exists()


def test_no_card_exits_without_a_result(capsys):
    import torch
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    rc = run.main(["--workload", "wts50.dense", "--seed", "1", "--seconds",
                   "1", "--trace", "0"])
    assert rc != 0 and capsys.readouterr().out == ""


def test_window_rate_reads_the_window_libraries():
    """``window_pairs_per_s``: the finished libraries' pairs over the
    window's seconds; nothing where the window finished none."""
    read = run.reader(run.ROOT, "window_pairs_per_s")
    libs = [{"pairs": 1_000_000}, {"pairs": 1_000_000}, {"pairs": 500_000}]
    assert read(run.Context(libs, None, None, None, 10.0)) == 250_000.0
    assert read(run.Context([], None, None, None, 10.0)) is None
    assert read(run.Context(libs, None, None, None)) is None
