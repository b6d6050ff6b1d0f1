"""The cohort coordinator's own logic and what its library processes share,
on the CPU: a freed worker slot starts the next library at once, each
library's ``elapsed_s`` runs from its spawn to its exit, the card check
needs no ``torch``, and library processes that start at once build the
native library once and all load it."""

import json
import os
import pathlib
import subprocess
import sys
import time

import pytest

from defuse_tpu_torch.cluster import native
from defuse_tpu_torch.pipeline import cohort

REPO = pathlib.Path(__file__).resolve().parent.parent

# a library process that stands in for ``run``: it notes its start and end
# on CLOCK_MONOTONIC, sleeps as long as its name says, and writes results
STUB = """import pathlib, sys, time
out, seconds = pathlib.Path(sys.argv[1]), float(sys.argv[2])
start = time.monotonic_ns()
time.sleep(seconds)
(out / "results.filtered.tsv").write_text("gene1\\tgene2\\n")
(out / "times").write_text(f"{start} {time.monotonic_ns()}")
"""
SECONDS = {"lib0": 3.0, "lib1": 0.2, "lib2": 0.2, "lib3": 0.2}


def test_freed_slot_starts_the_next_library(tmp_path, monkeypatch):
    """With two slots and a first library that runs much longer than the
    others, the third library starts as soon as the second ends, before
    the first ends; the second's seconds end at its own exit."""
    manifest = tmp_path / "cohort.tsv"
    manifest.write_text("".join(f"{n}\tr1.fq\tr2.fq\n" for n in SECONDS))

    def stub(config, dataset, libdir, lb, device, use_device):
        return [sys.executable, "-c", STUB, str(libdir),
                str(SECONDS[lb.name])]
    monkeypatch.setattr(cohort, "library_command", stub)
    out = tmp_path / "out"
    paths = cohort.run_cohort("config.txt", "dataset", str(manifest),
                              str(out), workers=2, use_device=False,
                              device="cpu")
    times = {n: list(map(int, (out / n / "times").read_text().split()))
             for n in SECONDS}
    assert times["lib2"][0] < times["lib0"][1]
    assert times["lib3"][0] < times["lib0"][1]
    rows = [r.split("\t") for r in
            pathlib.Path(paths["summary"]).read_text().splitlines()[1:]]
    assert [r[:2] for r in rows] == [[n, "ok"] for n in SECONDS]
    elapsed = {r[0]: float(r[3]) for r in rows}
    assert elapsed["lib0"] >= SECONDS["lib0"]
    assert max(elapsed[n] for n in ("lib1", "lib2", "lib3")) < \
        SECONDS["lib0"] / 2


def test_card_check_raises_without_libcuda(monkeypatch):
    """The coordinator's card check asks ``libcuda.so.1``; where it is
    absent the check raises with ``require_cuda``'s message, and a CPU
    device asks nothing."""
    monkeypatch.setattr(cohort, "LIBCUDA", "libcuda-absent.so.1")
    with pytest.raises(RuntimeError, match="is_available"):
        cohort.require_card("cuda")
    with pytest.raises(RuntimeError, match="is_available"):
        cohort.require_card("cuda:0")
    cohort.require_card("cpu")


COORDINATOR = """import json, sys
from defuse_tpu_torch.cli.main import main
rc = main(sys.argv[1:])
print(json.dumps({"rc": rc, "torch": "torch" in sys.modules}))
"""


def test_cpu_coordinator_imports_no_torch(tmp_path):
    """A ``--device cpu`` cohort whose libraries have their results (so the
    coordinator checks, skips them and merges) ends with ``torch`` absent
    from the coordinator's modules: only the library processes need it."""
    for name in ("libA", "libB"):
        (tmp_path / "out" / name).mkdir(parents=True)
        (tmp_path / "out" / name / "results.filtered.tsv").write_text(
            "gene1\tgene2\nGA\tGB\n")
    manifest = tmp_path / "cohort.tsv"
    manifest.write_text("libA\ta.1.fq\ta.2.fq\nlibB\tb.1.fq\tb.2.fq\n")
    proc = subprocess.run(
        [sys.executable, "-c", COORDINATOR, "cohort", "-c", "config.txt",
         "-d", "dataset", "-m", str(manifest), "-o", str(tmp_path / "out"),
         "-w", "2", "--device", "cpu"],
        capture_output=True, text=True, cwd=REPO, timeout=300,
        env=os.environ | {"PYTHONPATH": str(REPO)})
    assert proc.returncode == 0, proc.stderr[-3000:]
    assert json.loads(proc.stdout.splitlines()[-1]) == {"rc": 0,
                                                        "torch": False}
    recurrent = (tmp_path / "out" / "cohort_recurrent.tsv").read_text()
    assert recurrent.splitlines()[1] == "GA\tGB\t2\tlibA,libB"


# ``native/build.sh`` as the loader runs it, standing in for ``g++``: it
# counts its runs and writes the library in two parts, a while apart, to
# its final path, as ``g++ -o`` does
BUILD = """#!/bin/bash
set -e
HERE="$(cd "$(dirname "$0")" && pwd)"
echo built >> "$HERE/builds"
head -c 4096 "{src}" > "$HERE/libdefuse_host.so"
sleep 2
cat "{src}" > "$HERE/libdefuse_host.so"
"""
LOAD = """import pathlib, sys
from defuse_tpu_torch.cluster import native
native._LIB_PATH = pathlib.Path(sys.argv[1])
lib = native.load_library()
print(lib is not None and lib._name == sys.argv[1])
"""


def test_concurrent_loads_build_the_native_library_once(tmp_path):
    """Three processes that load the library at once from a location
    where it is missing: one builds it, the others wait for the build,
    and all three load the whole library."""
    assert native.load_library() is not None
    (tmp_path / "build.sh").write_text(BUILD.format(src=native._LIB_PATH))
    target = tmp_path / "libdefuse_host.so"
    procs = [subprocess.Popen([sys.executable, "-c", LOAD, str(target)],
                              stdout=subprocess.PIPE, stderr=subprocess.PIPE,
                              text=True, cwd=REPO,
                              env=os.environ | {"PYTHONPATH": str(REPO)})
             for _ in range(3)]
    t0 = time.monotonic()
    got = [p.communicate(timeout=300) for p in procs]
    assert [p.returncode for p in procs] == [0, 0, 0], \
        [err[-2000:] for _out, err in got]
    assert [out.split() for out, _err in got] == [["True"]] * 3
    assert (tmp_path / "builds").read_text() == "built\n"
    assert target.read_bytes() == native._LIB_PATH.read_bytes()
    assert time.monotonic() - t0 >= 2
