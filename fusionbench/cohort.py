"""The window of a cohort cell: ``defuse cohort`` over the pool's manifest,
as its users run it, one call after another, each a process of its own
that starts a process a library (``cohort.workers`` of them at once).

A call is waited for with ``os.wait4``: its ``ru_maxrss`` is the largest
resident high-water mark of the cohort process and of every library
process it waited for, so a cohort cell's ``peak_rss_gib`` is the memory
one library's process takes, which is what a job slot is sized by.  What a
library did is read from what it wrote: ``cohort_summary.tsv`` (its status
and seconds), its ``metrics.json`` (stages and the program's spans) and
``metrics.discover.json`` (discover's seconds and counters).

The card's timeline of a traced window is read from the library processes'
own profiles: each window call runs with ``DEFUSE_TORCH_PROFILE`` set to a
fresh directory (``profile_env``), which the cohort passes on to every
library process it starts, and each library's run writes its whole
Chrome trace there (``<dir>/<run id>/trace.json``, the run id of its
``metrics.json`` spans).  ``torch.profiler`` in the harness's own process
sees no other process's operations.  An untraced window sets nothing and
reads no trace.
"""

from __future__ import annotations

import csv
import dataclasses
import json
import os
import pathlib
import subprocess
import sys
import threading
import time

import observe

ROOT = pathlib.Path(__file__).resolve().parent.parent
# what a finished library leaves that the harness reads
NEEDED = ("metrics.json", "metrics.discover.json", *observe.FILES)


@dataclasses.dataclass
class Call:
    rc: int
    seconds: float
    maxrss_bytes: int       # wait4's ru_maxrss: the largest of its processes


def command(prepared: dict, manifest, out, workers: int,
            device: str) -> list[str]:
    """``defuse cohort`` over ``manifest`` into ``out``."""
    return [sys.executable, "-m", "defuse_tpu_torch", "cohort",
            "-c", prepared["config"], "-d", prepared["dataset"],
            "-m", str(manifest), "-o", str(out), "-w", str(workers),
            "--device", device]


def call(cmd: list[str], env: dict | None = None) -> Call:
    """Run one cohort call from the program's root, its output on this
    process's standard error, and wait for it with ``wait4``."""
    t0 = time.perf_counter()
    proc = subprocess.Popen(cmd, cwd=ROOT, stdin=subprocess.DEVNULL,
                            stdout=2, env=env)
    _pid, status, usage = os.wait4(proc.pid, 0)
    proc.returncode = os.waitstatus_to_exitcode(status)
    return Call(proc.returncode, time.perf_counter() - t0,
                usage.ru_maxrss * 1024)


def summary(out: pathlib.Path) -> dict[str, dict]:
    """``cohort_summary.tsv`` by library name; empty where it is missing."""
    path = out / "cohort_summary.tsv"
    if not path.exists():
        return {}
    with open(path) as fh:
        return {r["library"]: r for r in csv.DictReader(fh, delimiter="\t")}


def profile_env(directory: pathlib.Path) -> dict:
    """This process's environment with the program's whole-run profile
    (``utils.profiling.library``) sent to ``directory``."""
    return os.environ | {"DEFUSE_TORCH_PROFILE": str(directory)}


def span_seconds(run_m: dict) -> dict[str, float] | None:
    """Seconds of each of the program's span names in a library's
    ``metrics.json``, summed (what ``profiling.RUN_SPANS`` holds for a run
    in the same process); None where it records no spans."""
    if "spans" not in run_m:
        return None
    out: dict[str, float] = {}
    for s in run_m["spans"]:
        out[s["name"]] = out.get(s["name"], 0.0) + \
            (s["end_ns"] - s["start_ns"]) / 1e9
    return out


def library_record(libdir: pathlib.Path) -> dict:
    """A finished library's record, in the shape of ``run.run_library``'s,
    with the program's span seconds (``spans``) and its run id (``run``,
    which names its profile's directory); no launches (they are counted
    only in-process)."""
    run_m = json.loads((libdir / "metrics.json").read_text())
    disc_m = json.loads((libdir / "metrics.discover.json").read_text())
    stages = {s["stage"]: s["seconds"] for s in run_m["stages"]}
    spans = span_seconds(run_m)
    timed = {} if spans is None else {
        n: spans[n] for n in ("read stats", "covariance samples")
        if n in spans}
    host = None if spans is None else \
        sum(v for k, v in stages.items() if k != "discover") + \
        timed.get("read stats", 0.0) + timed.get("covariance samples", 0.0)
    counters = disc_m["counters"]
    return {
        "discover_s": disc_m["total_seconds"],
        "run_stages_s": host,
        "stages": {k: round(v, 4) for k, v in (stages | timed).items()},
        "split_dp_impl": counters.get("split_dp_impl"),
        "screen_route": counters.get("screen_route"),
        "screen_candidates": counters.get("screen_candidates", 0),
        "screen_survivors": counters.get("screen_survivors", 0),
        "bytes_written": observe.out_bytes(libdir),
        "run": run_m["spans"][0]["run"] if run_m.get("spans") else None,
        "spans": spans,
    }


def read_call(out: pathlib.Path, names: list[str]) -> dict[str, dict | None]:
    """Each library's record, or None for a library that the summary does
    not mark ``ok`` or that lacks a file the harness reads."""
    rows = summary(out)
    got: dict[str, dict | None] = {}
    for name in names:
        row, libdir = rows.get(name), out / name
        missing = [f for f in NEEDED if not (libdir / f).exists()]
        if row is None or row["status"] != "ok" or missing:
            got[name] = None
            log = libdir / "cohort.log"
            tail = log.read_text()[-2000:] if log.exists() else ""
            print(f"[cohort] library {name} not finished: status "
                  f"{row and row['status']}, missing {missing}\n{tail}",
                  file=sys.stderr, flush=True)
            continue
        got[name] = library_record(libdir) | {
            "seconds": float(row["elapsed_s"])}
    return got


class CardMemory:
    """The most memory that the window's processes held on the cell's
    card: its used memory (``torch.cuda.mem_get_info``: every process's
    context and allocations) sampled every ``period`` seconds on a thread,
    less its reading at the window's start, which takes in this process's
    own context.  ``peak`` is None off the card."""

    def __init__(self, device: str, period: float = 0.05):
        self.on, self.period = device == "cuda", period
        self.peak: int | None = None

    @staticmethod
    def _used() -> int:
        import torch
        free, total = torch.cuda.mem_get_info(0)
        return total - free

    def _sample(self):
        while not self._stop.wait(self.period):
            self._high = max(self._high, self._used())

    def __enter__(self):
        if self.on:
            self._start = self._high = self._used()
            self._stop = threading.Event()
            self._thread = threading.Thread(target=self._sample, daemon=True)
            self._thread.start()
        return self

    def __exit__(self, *exc):
        if self.on:
            self._stop.set()
            self._thread.join()
            self.peak = max(self._high, self._used()) - self._start
