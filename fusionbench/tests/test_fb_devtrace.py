"""The card's timeline of a cohort window, merged from its library
processes' own Chrome traces: two recorded traces whose
``baseTimeNanoseconds`` differ by 4 s, with device operations that
overlap across the two processes, nested program ranges, and time that
lies in neither library's profile."""

import shutil

import pytest

import devtrace
import run
from conftest import HERE

W = 1_790_000_000_000_000_000          # the window's start, epoch ns
KERNEL = "void (anonymous namespace)::screen_kernel<18, 16>(unsigned char*)"


@pytest.fixture
def profiles(tmp_path):
    """The two traces as a traced window's calls leave them:
    ``<call>/<run id>/trace.json``."""
    for call, run_id in (("call0", "runa"), ("call1", "runb")):
        (tmp_path / call / run_id).mkdir(parents=True)
        shutil.copy(HERE / "fixtures" / f"trace_lib_{run_id[-1]}.json",
                    tmp_path / call / run_id / "trace.json")
    return tmp_path


LIBRARIES = [{"run": "runa", "call": 1, "pool": 0},
             {"run": "runb", "call": 2, "pool": 0}]


def test_traces_merge_on_the_epoch(profiles, capsys):
    trace = run.cohort_trace(profiles, LIBRARIES, 2, W, W + 10 * 10 ** 9)
    assert trace.window_s == pytest.approx(10.0)
    # a's copy 3.0990-3.1001 s and kernel 3.1000-3.1003, b's set
    # 3.1002-3.1005 (b's clock 4 s on a's): one stretch of 1.5 ms; b's
    # kernel 0.4 ms
    assert trace.busy_s == pytest.approx(0.0019, abs=1e-9)
    assert trace.kernels[KERNEL] == pytest.approx(0.0007, abs=1e-9)
    assert trace.launches == {KERNEL: 2, "Memset (Device)": 1,
                              "Memcpy HtoD (Pageable -> Device)": 1}
    assert trace.kernels["Memcpy HtoD (Pageable -> Device)"] == \
        pytest.approx(0.0011, abs=1e-9)
    by_name: dict[str, float] = {}
    for name, s in trace.gaps:
        by_name[name] = by_name.get(name, 0.0) + s
    assert by_name == pytest.approx({
        # 0-1 s before either library's ranges, 6-10 s after both
        "between": 5.0,
        # a's 1-2 s; b's 4-5 s, where a's range has closed
        "defuse:frontend": 2.0,
        # a's 2-3 s and 3.5-4 s, shorter than b's frontend open beside
        # it; b's 5-6 s less its kernel
        "defuse:discover": 2.4996,
        # nested in a's discover, less the busy 1.5 ms
        "defuse:discover:screen:device": 0.4985,
    }, abs=1e-9)
    assert trace.gaps[0] == ("between", pytest.approx(4.0))
    assert sum(by_name.values()) == pytest.approx(10 - 0.0019, abs=1e-9)
    err = capsys.readouterr().err
    assert "screen_kernel launches 2 for 2 finished libraries" in err
    assert '[trace] call 1, lib0: {"screen_kernel": {"launches": 1, ' \
        '"seconds": 0.0003' in err


def test_a_missing_profile_reads_no_timeline(profiles, capsys):
    assert run.cohort_trace(profiles, LIBRARIES, 3, W, W + 10 ** 10) is None
    assert "2 library profiles for 3 library processes" in \
        capsys.readouterr().err


def test_program_ranges_name_gaps_before_the_harness():
    """In a ``run`` cell the harness's ``library`` span names only what no
    program range covers, however long the program's range is."""
    events = [("fusionbench:library", False, 0.0, 10.0),
              ("defuse:frontend", False, 1.0, 9.0),
              ("defuse:frontend.ingest", False, 2.0, 3.0),
              ("fusionbench:library", True, 0.0, 10.0)]
    trace = devtrace.analyse(events, (0.0, 12.0))
    assert trace.busy_s == 0 and trace.launches == {}
    assert sorted((n, round(s * 1e6, 9)) for n, s in trace.gaps) == [
        ("between", 2), ("defuse:frontend", 1), ("defuse:frontend", 6),
        ("defuse:frontend.ingest", 1), ("fusionbench:library", 1),
        ("fusionbench:library", 1)]
