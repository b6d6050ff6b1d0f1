"""A cell driven through ``defuse cohort`` (a configuration's ``verb``), a
mix whose screen route is the program's to choose (``screen: auto``), and
the seeds of a pool of any size: a tiny cohort cell found from new files
alone prints the contract line with the peak from ``wait4``, and traced,
the card's timeline from its library processes' own profiles; a library
process that fails, or whose results are missing, reads as not correct;
a route that disagrees with the program's recorded choice is counted."""

import json
import os
import pathlib
import sys
import types

import numpy as np
import pytest

import cohort
import generator
import prepare
import run
from conftest import BENCH, ROOT

SEED = 2 ** 31 + 91


def add_cell(tree, config, traffic, cfg_keys=None, mix=None):
    """A cell ``<config>.<traffic>`` added to the tree as new files and
    entries: a copy of the tiny configuration with ``cfg_keys``, the mix
    ``mix`` (where given)."""
    cfgs = tree / "fusionbench" / "configs"
    if cfg_keys is not None:
        cfg = json.loads((cfgs / "tiny.json").read_text())
        cfg |= {"name": config} | cfg_keys
        (cfgs / f"{config}.json").write_text(json.dumps(cfg))
    if mix is not None:
        (tree / "fusionbench" / "traffic" / f"{traffic}.json").write_text(
            json.dumps(mix))
    bench = json.loads((tree / "BENCHMARK.json").read_text())
    if cfg_keys is not None:
        bench["configs"].append({"name": config, "source": "test",
                                 "file": f"fusionbench/configs/{config}.json",
                                 "reduced": [], "why": "test"})
    bench["workloads"].append({"name": f"{config}.{traffic}",
                               "config": config, "traffic": traffic,
                               "chips": 1, "why": "test"})
    (tree / "BENCHMARK.json").write_text(json.dumps(bench))
    return f"{config}.{traffic}"


COHORT = {"verb": "cohort", "cohort": {"libraries": 2, "workers": 2}}
AUTO_MIX = {"name": "fewauto", "fusions": 50, "frags_per_fusion": 150,
            "decoy_share": 0.05, "screen": "auto"}


@pytest.fixture
def cohort_tree(tiny_tree):
    add_cell(tiny_tree, "tinyc", "few", COHORT)
    return tiny_tree


@pytest.fixture
def calls(monkeypatch):
    """Every cohort call's ``Call`` and the environment it was given (None:
    this process's), in order (the warm-up's first)."""
    seen = []
    real = cohort.call

    def recorded(cmd, env=None):
        got = real(cmd, env)
        seen.append((got, env))
        return got
    monkeypatch.setattr(cohort, "call", recorded)
    return seen


@pytest.fixture
def records(monkeypatch):
    """Every library record the harness reads, in order."""
    seen = []
    real = cohort.library_record

    def recorded(libdir):
        rec = real(libdir)
        seen.append(rec)
        return rec
    monkeypatch.setattr(cohort, "library_record", recorded)
    return seen


def result(tree, capsys, workload, trace=0, err=None):
    """The run's result line; its standard error appended to ``err``."""
    rc = run.main(["--workload", workload, "--seed", str(SEED),
                   "--seconds", "1", "--trace", str(trace)],
                  require_card=False, device="cpu", root=tree,
                  cache=tree / "cache")
    assert rc == 0
    got = capsys.readouterr()
    if err is not None:
        err.append(got.err)
    return json.loads(got.out.strip().splitlines()[-1])


def test_cohort_cell_from_new_files(cohort_tree, capsys, calls):
    cell = run.Cell("tinyc.few", cohort_tree)
    assert (cell.verb, cell.n_libraries, cell.workers) == ("cohort", 2, 2)
    res = result(cohort_tree, capsys, "tinyc.few")
    assert list(res)[:5] == ["correct", "attempted", "failed", "metrics",
                             "device"]
    assert list(res)[-1] == "checks"
    assert res["correct"] is True and res["failed"] == 0
    assert res["attempted"] == 2 * (len(calls) - 1)
    assert set(res["metrics"]) == {"peak_rss_gib", "setup_s"}
    assert all(m["value"] > 0 for m in res["metrics"].values())
    # no profile asked of any call, nor of the library processes
    assert all(env is None for _, env in calls)
    assert "DEFUSE_TORCH_PROFILE" not in os.environ
    assert not {"busy_s", "window_s"} & set(res["device"])
    assert "breakdown" not in res
    # the largest wait4 mark of the window's calls; not the warm-up's
    peak = max(c.maxrss_bytes for c, _ in calls[1:])
    assert res["metrics"]["peak_rss_gib"]["value"] == peak / 2 ** 30
    for check in res["checks"].values():
        assert check["value"] <= check["limit"]


def test_traced_cohort_cell_reads_the_programs_spans(cohort_tree, capsys,
                                                     calls, records):
    """A traced cohort cell reads the program's spans and stages from each
    library's files, ``frontend_s`` the mean of its ``frontend`` span, and
    the card's timeline from each window call's library profiles (the
    warm-up's not profiled): every per-layer metric that names no
    ``workloads``, ``busy_s``, ``window_s`` and a breakdown."""
    err = []
    res = result(cohort_tree, capsys, "tinyc.few", trace=1, err=err)
    assert res["correct"] is True
    bench = json.loads((cohort_tree / "BENCHMARK.json").read_text())
    everywhere = {m["name"] for m in bench["per_layer"]
                  if "workloads" not in m}
    assert {"frontend_s", "device_idle_pct"} <= everywhere
    assert everywhere <= set(res["metrics"])
    assert "screen_roofline_pct" not in res["metrics"]
    window = records[-res["attempted"]:]     # the warm-up's read first
    assert len(window) == res["attempted"] == 2 * (len(calls) - 1)
    assert res["metrics"]["frontend_s"]["value"] == pytest.approx(
        sum(r["spans"]["frontend"] for r in window) / len(window),
        rel=1e-12)
    device = res["device"]
    assert device["window_s"] > 0 and 0 <= device["busy_s"] <= \
        device["window_s"]
    assert set(res["breakdown"]) == {"device_ops", "idle_gaps"}
    # the library processes' ranges name the gaps
    assert any(n.startswith("defuse:") for n, _ in
               res["breakdown"]["idle_gaps"])
    assert f"for {res['attempted']} finished libraries" in err[0]
    assert calls[0][1] is None
    dirs = [env["DEFUSE_TORCH_PROFILE"] for _, env in calls[1:]]
    assert len(set(dirs)) == len(dirs)
    assert "DEFUSE_TORCH_PROFILE" not in os.environ


SHIM = '''import pathlib, subprocess, sys
fault, cmd = sys.argv[1], sys.argv[2:]
out = pathlib.Path(cmd[cmd.index("-o") + 1])
if fault == "exits_nonzero":
    at = cmd.index("-m", cmd.index("cohort")) + 1
    text = pathlib.Path(cmd[at]).read_text()
    rows = [r.split("\\t") for r in text.splitlines()]
    rows[1][1] = str(out) + ".missing.fq"
    bad = pathlib.Path(str(out) + ".tsv")
    bad.write_text("".join("\\t".join(r) + "\\n" for r in rows))
    cmd[at] = str(bad)
rc = subprocess.call(cmd)
if fault == "results_missing":
    (out / "lib1" / "results.tsv").unlink()
sys.exit(rc)
'''


@pytest.mark.parametrize("fault", ["exits_nonzero", "results_missing"])
def test_failed_library_is_not_correct(cohort_tree, capsys, monkeypatch,
                                       tmp_path, fault):
    """The window's calls go through a shim that makes the second library
    fail (its FASTQ missing, so its process exits non-zero) or removes its
    results after the call."""
    shim = tmp_path / "shim.py"
    shim.write_text(SHIM)
    real = cohort.command

    def command(prepared, manifest, out, workers, device):
        cmd = real(prepared, manifest, out, workers, device)
        if manifest != prepared["manifest"]:
            return cmd                      # the warm-up call as it is
        return [sys.executable, str(shim), fault, *cmd]
    monkeypatch.setattr(cohort, "command", command)
    res = result(cohort_tree, capsys, "tinyc.few")
    assert res["correct"] is False
    assert res["failed"] >= 1 and res["failed"] * 2 == res["attempted"]


def _fake_device_route(discover):
    """The screen's route recorded as ``device``, and no screen run (the
    native realign then takes every candidate, so the answer stays
    right)."""
    real = discover._screen_route

    def route(*args):
        return {**real(*args), "choice": "device"}
    return route


@pytest.mark.parametrize("faked", [False, True, "forced_off"])
def test_auto_screen_is_held_to_the_programs_choice(tiny_tree, capsys,
                                                    monkeypatch, faked):
    """``faked``: the route recorded as the card's with no screen run;
    ``forced_off``: the program's own switch sends the screen to the host,
    which it records as its choice, not the one ``auto`` makes."""
    workload = add_cell(tiny_tree, "tiny", "fewauto", mix=AUTO_MIX)
    assert run.Cell(workload, tiny_tree).screen == "auto"
    if faked == "forced_off":
        monkeypatch.setenv("DEFUSE_DEVICE_SCREEN", "off")
    elif faked:
        from defuse_tpu_torch.pipeline import discover
        monkeypatch.setattr(discover, "_screen_route",
                            _fake_device_route(discover))
        monkeypatch.setattr(discover, "_screen", lambda *a: None)
    res = result(tiny_tree, capsys, workload)
    check = res["checks"]["screen_off_card"]
    assert check["limit"] == 0
    if faked:
        assert check["value"] == res["attempted"] >= 1
        assert res["correct"] is False
    else:
        assert check["value"] == 0 and res["correct"] is True


def record(impl, route, candidates, launches=None, mode="auto"):
    rec = {"split_dp_impl": impl, "screen_candidates": candidates,
           "screen_route": route and {"choice": route, "mode": mode}}
    if launches is not None:
        rec["launches"] = {"split_dp_screen": launches}
    return rec


@pytest.mark.parametrize("rec, device, mode, off", [
    # the card's route asked for: today's check, on the card only
    (record("cuda", "device", 100, 1), "cuda", "device", 0),
    (record("cuda", "device", 100, 0), "cuda", "device", 1),
    (record(None, "host", 100, 0), "cuda", "device", 1),
    (record(None, "host", 100, 0), "cpu", "device", 0),
    # a cohort library: no launches counted, its candidates instead
    (record("cuda", "device", 100), "cuda", "device", 0),
    (record("cuda", "device", 0), "cuda", "device", 1),
    # the program's choice
    (record("cuda", "device", 100, 1), "cuda", "auto", 0),
    (record(None, "host", 100, 0), "cuda", "auto", 0),
    (record("cuda", "host", 100, 1), "cuda", "auto", 1),
    (record(None, "device", 100, 0), "cuda", "auto", 1),
    (record("cuda", "device", 100, 0), "cuda", "auto", 1),
    (record(None, None, 0, 0), "cuda", "auto", 1),
    (record("torch", "device", 100), "cpu", "auto", 0),
    (record(None, "device", 100), "cpu", "auto", 1),
    # a route forced by the program's switch is not the program's choice
    (record(None, "host", 100, 0, mode="off"), "cuda", "auto", 1),
    (record("cuda", "device", 100, 1, mode="force"), "cuda", "auto", 1),
    (record(None, "host", 100, 0, mode="off"), "cpu", "auto", 1),
])
def test_screen_off_card(rec, device, mode, off):
    assert run.screen_off_card([rec], mode, device) == off


def today_seeds(seed):
    """The three seeds of a pool of two and its warm-up, as they were
    before pools of other sizes."""
    ss = np.random.SeedSequence(seed)
    return [int(s.generate_state(1, np.uint64)[0]) for s in ss.spawn(3)]


@pytest.mark.parametrize("n", [1, 2, 3, 4, 8])
@pytest.mark.parametrize("seed", [0, 7, 2 ** 31 + 5, 2 ** 40 + 1])
def test_library_seeds_keep_todays(n, seed):
    got = prepare.library_seeds(seed, n)
    old = today_seeds(seed)
    assert len(got) == n + 1 and len(set(got)) == n + 1
    assert got[:min(n, 2)] == old[:min(n, 2)] and got[-1] == old[2]
    assert prepare.library_seeds(seed) == old


def test_run_cell_fastq_as_before(tiny_tree, tmp_path):
    """A ``run`` cell's pool and warm-up FASTQ are those of the seeds of
    before, byte for byte; a cohort pool of four begins with them."""
    add_cell(tiny_tree, "tinyc", "few",
             {"verb": "cohort", "cohort": {"libraries": 4, "workers": 2}})
    cell = run.Cell("tiny.few", tiny_tree)
    got = prepare.prepare(cell, SEED, tmp_path / "run", tiny_tree / "cache")
    big = prepare.prepare(run.Cell("tinyc.few", tiny_tree), SEED,
                          tmp_path / "cohort", tiny_tree / "cache")
    assert "manifest" not in got and len(big["libs"]) == 4
    genes = generator.Genes.load(got["genes"])
    s0, s1, sw = today_seeds(SEED)
    want = []
    for k, s, n in ((0, s0, None), (1, s1, None),
                    ("w", sw, prepare.WARMUP_PAIRS)):
        lib = generator.make_library(cell.cfg, cell.mix, genes, s, n)
        want.append(generator.write_library(lib, genes, s,
                                            tmp_path / f"want{k}")[:2])
    have = [got["libs"][0]["fq"], got["libs"][1]["fq"], got["warm"]]
    cohort_have = [big["libs"][0]["fq"], big["libs"][1]["fq"], big["warm"]]
    for w, h, c in zip(want, have, cohort_have):
        for a, b, d in zip(w, h, c):
            assert pathlib.Path(a).read_bytes() == \
                pathlib.Path(b).read_bytes() == pathlib.Path(d).read_bytes()
    rows = [r.split("\t") for r in
            pathlib.Path(big["manifest"]).read_text().splitlines()]
    assert [r[0] for r in rows] == ["lib0", "lib1", "lib2", "lib3"]
    assert [r[1:] for r in rows] == [lb["fq"] for lb in big["libs"]]


def test_library_record_reads_the_programs_files(tmp_path):
    """A cohort library's record from its ``metrics.json`` and
    ``metrics.discover.json``; the span readers then read its spans."""
    lib = tmp_path / "lib0"
    lib.mkdir()
    spans = [("frontend", 0, 2.0), ("frontend.ingest", 0, 0.5),
             ("read stats", 2.0, 2.25), ("covariance samples", 2.5, 3.0),
             ("breakseq.index_load", 4.0, 4.125)]
    (lib / "metrics.json").write_text(json.dumps({
        "stages": [{"stage": "discover", "seconds": 1.5},
                   {"stage": "breakseq", "seconds": 0.25},
                   {"stage": "annotation", "seconds": 0.5}],
        "spans": [{"name": n, "run": "r0", "start_ns": int(a * 1e9),
                   "end_ns": int(b * 1e9)} for n, a, b in spans]}))
    (lib / "metrics.discover.json").write_text(json.dumps({
        "total_seconds": 1.4, "counters": {
            "split_dp_impl": "cuda", "screen_candidates": 2500,
            "screen_route": {"choice": "device"}}}))
    rec = cohort.library_record(lib)
    assert "frontend_s" not in rec and rec["discover_s"] == 1.4
    assert rec["run"] == "r0"
    assert rec["run_stages_s"] == pytest.approx(0.25 + 0.5 + 0.25 + 0.5)
    assert rec["screen_route"] == {"choice": "device"}
    ctx = types.SimpleNamespace(libraries=[rec, rec], trace=None)
    assert run.reader(run.ROOT, "ingest_s")(ctx) == 0.5
    assert run.reader(run.ROOT, "index_load_s")(ctx) == 0.125
    assert run.reader(run.ROOT, "frontend_s")(ctx) == 2.0
    assert run.reader(run.ROOT, "breakseq_s")(ctx) == 0.25
    # a program without spans: nothing where a span is needed
    (lib / "metrics.json").write_text(json.dumps({"stages": [
        {"stage": "breakseq", "seconds": 0.25}]}))
    bare = cohort.library_record(lib)
    ctx = types.SimpleNamespace(libraries=[bare], trace=None)
    for name in ("frontend_s", "run_stages_s", "ingest_s"):
        assert run.reader(run.ROOT, name)(ctx) is None, name


def test_benchmark_mixes_name_a_known_route():
    bench = json.loads((ROOT / "BENCHMARK.json").read_text())
    for w in bench["workloads"]:
        cell = run.Cell(w["name"], ROOT)
        assert cell.screen in prepare.SCREENS and cell.verb in prepare.VERBS
    assert json.loads((BENCH / "traffic" / "dense.json").read_text()).get(
        "screen", "device") == "device"
