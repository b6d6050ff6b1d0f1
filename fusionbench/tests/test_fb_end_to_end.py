"""A tiny cell through ``run.py`` on CPU tensors (the look for a card
skipped, the rest of a run as it is): the last line has the contract's
shape and is correct; with the timed path broken underneath it is not;
the control is not.  The card's own run is the ``cuda`` test."""

import json

import pytest

import compare
import control
import run

ARGS = ["--workload", "tiny.few", "--seed", str(2 ** 31 + 77),
        "--seconds", "1"]


def result(tree, capsys, trace=0):
    rc = run.main(ARGS + ["--trace", str(trace)], require_card=False,
                  device="cpu", root=tree, cache=tree / "cache")
    assert rc == 0
    return json.loads(capsys.readouterr().out.strip().splitlines()[-1])


def test_tiny_run_prints_the_contract_line(tiny_tree, capsys):
    res = result(tiny_tree, capsys)
    assert list(res)[:5] == ["correct", "attempted", "failed", "metrics",
                             "device"]
    assert list(res)[-1] == "checks"
    assert res["correct"] is True and res["failed"] == 0
    assert res["attempted"] >= 1
    assert set(res["metrics"]) == {"peak_rss_gib", "setup_s"}
    assert all(m["value"] > 0 for m in res["metrics"].values())
    for check in res["checks"].values():
        assert check["value"] <= check["limit"]
    traced = result(tiny_tree, capsys, trace=1)
    assert traced["correct"] is True
    assert {"frontend_s", "discover_s", "run_stages_s",
            "window_pairs_per_s"} <= set(traced["metrics"])
    assert "busy_s" in traced["device"] and "breakdown" in traced


def _drop_half_of_spanning(align_reads):
    def broken(*args, **kw):
        aligned = align_reads(*args, **kw)
        path = aligned["spanning"]
        with open(path) as fh:
            rows = fh.readlines()
        ids = sorted({r.split("\t", 1)[0] for r in rows}, key=int)
        keep = set(ids[:len(ids) // 2])
        with open(path, "w") as fh:
            fh.writelines(r for r in rows if r.split("\t", 1)[0] in keep)
        return aligned
    return broken


def _shift_the_breakpoints(discover):
    """Every split-read breakpoint one base on, as discover writes it."""
    def broken(**kw):
        out = discover(**kw)
        path = f"{kw['outdir']}/splitreads.break"
        with open(path) as fh:
            rows = [r.rstrip("\n").split("\t") for r in fh]
        for r in rows:
            r[4] = str(int(r[4]) + 1)
        with open(path, "w") as fh:
            fh.writelines("\t".join(r) + "\n" for r in rows)
        return out
    return broken


@pytest.mark.parametrize("fault, number", [
    ("half_left_out", "frontend_pairs_differ"),
    ("answer_altered", "fusion_disagreements")])
def test_broken_path_is_not_correct(tiny_tree, capsys, monkeypatch, fault,
                                    number):
    from defuse_tpu_torch.align import frontend
    from defuse_tpu_torch.pipeline import run as run_module
    if fault == "half_left_out":
        monkeypatch.setattr(frontend, "align_reads",
                            _drop_half_of_spanning(frontend.align_reads))
    else:
        monkeypatch.setattr(run_module, "discover_fusions",
                            _shift_the_breakpoints(run_module.discover_fusions))
    res = result(tiny_tree, capsys)
    assert res["correct"] is False, res["checks"]
    check = res["checks"][number]
    assert check["value"] > check["limit"]


def test_control_is_not_correct(tiny_tree, capsys):
    assert control.main(["--workload", "tiny.few", "--seeds", "1", "2", "3"],
                        root=tiny_tree) == 0
    lines = [json.loads(x) for x in capsys.readouterr().out.splitlines()]
    assert [x["correct"] for x in lines] == [False] * 6
    for x in lines:       # each control fails the number it is named for
        number = {"exact_alignment": "frontend_pairs_differ",
                  "breakpoint_moved": "fusion_disagreements"}[x["control"]]
        assert x["numbers"][number] > compare.LIMITS[number]


@pytest.mark.cuda
def test_cell_on_card(card, capsys):
    rc = run.main(["--workload", "wts50.dense", "--seed", "7", "--seconds",
                   "5", "--trace", "0"])
    assert rc == 0
    res = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert res["correct"] is True and res["device"]["platform"] == "gpu"
