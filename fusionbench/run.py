"""Run one cell of the port's benchmark once.

    python3 fusionbench/run.py --workload wts50.dense --seed 7 --seconds 10 \
        --trace 0

Set-up: import the port while a child process (``prepare.py``) builds or
loads the configuration's reference dataset (``build/fusionbench/ref/``,
once per configuration and generator) and generates from ``--seed`` a
pool of libraries as paired FASTQ; then warm up on one small library,
which builds or loads the port's kernels.  The window drives the program
as the configuration's ``verb`` says.  ``run`` (the default): ``defuse
run`` through the port's command line (``defuse_tpu_torch.cli.main.main``)
in this process, the pool's two libraries back to back until ``--seconds``
have passed.  ``cohort``: ``defuse cohort`` over the pool's manifest, a
process of its own a call and a library (``cohort.py``), call after call
until ``--seconds`` have passed.  Earlier outputs are removed after the
window.  Then the last run of each pooled library is held to the plain
reference (``compare.py``), and the last line of standard output is the
result.  ``--trace 1`` profiles the window (a cohort window's library
processes each profile themselves, ``cohort.py``) and reports the
per-layer metrics (``metrics/<name>.py``) instead of the end-to-end ones.
"""

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import contextlib  # noqa: E402
import dataclasses  # noqa: E402
import importlib.util  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import pathlib  # noqa: E402
import shutil  # noqa: E402
import subprocess  # noqa: E402
import sys  # noqa: E402
import tempfile  # noqa: E402
import traceback  # noqa: E402

HERE = pathlib.Path(__file__).resolve().parent
ROOT = HERE.parent
sys.path[:0] = [str(HERE), str(ROOT)]   # the benchmark's modules, the port

import cohort  # noqa: E402
import compare  # noqa: E402
import devtrace  # noqa: E402
import generator  # noqa: E402
import observe  # noqa: E402
import reference  # noqa: E402
import roofline  # noqa: E402
from prepare import CACHE, Cell, find, load_truth  # noqa: E402
from spans import RssPeak, span  # noqa: E402

FORBIDDEN = ("jax", "jaxlib", "flax", "defuse_tpu")


def say(*parts) -> None:
    print(*parts, file=sys.stderr, flush=True)


def forbidden_modules() -> list[str]:
    """Top-level names in ``sys.modules`` that the benchmark may not load,
    compared whole (``defuse_tpu_torch`` is not ``defuse_tpu``)."""
    return sorted({m.split(".")[0] for m in list(sys.modules)} &
                  set(FORBIDDEN))


def run_library(config, dataset, fq1, fq2, out: pathlib.Path,
                device: str) -> dict:
    """``defuse run`` on one library through the port's command line;
    its stage seconds and counters, read as a cohort library's are
    (``cohort.library_record``)."""
    from defuse_tpu_torch.cli.main import main as cli
    from defuse_tpu_torch.ops import split_dp_cuda
    split_dp_cuda.reset_launches()
    t0, c0 = time.perf_counter(), os.times()
    with contextlib.redirect_stdout(sys.stderr):
        rc = cli(["run", "-c", str(config), "-d", str(dataset), "-1",
                  str(fq1), "-2", str(fq2), "-o", str(out),
                  "--device", device])
    seconds = time.perf_counter() - t0
    c1 = os.times()
    if rc:
        raise RuntimeError(f"run exited {rc}")
    rec = cohort.library_record(out)
    # in this process the span readers take the program's spans from
    # ``profiling.RUN_SPANS`` (``program_spans.py``)
    del rec["spans"]
    return {
        "seconds": seconds,
        # the process's CPU seconds (all threads): with ``seconds``, whether
        # a slow library did its work slower or waited
        "cpu_s": round(c1.user + c1.system - c0.user - c0.system, 3),
        **rec,
        "launches": dict(split_dp_cuda.LAUNCHES),
    }


class ScreenWork:
    """Counts the screen's DP cells from its operands' shapes, around the
    program's ``screen_operands`` call in discover (a traced run only)."""

    def __init__(self):
        self.cells = 0
        self.calls = 0

    def __enter__(self):
        from defuse_tpu_torch.pipeline import discover
        self._saved = discover.screen_operands
        saved, work = self._saved, self

        def counted(u1p, u1l, u2rp, u2l, ref_idx, reads, read_lens, *rest):
            work.cells += roofline.screen_cells(u1l, u2l, ref_idx, read_lens)
            work.calls += 1
            return saved(u1p, u1l, u2rp, u2l, ref_idx, reads, read_lens,
                         *rest)

        discover.screen_operands = counted
        return self

    def __exit__(self, *exc):
        from defuse_tpu_torch.pipeline import discover
        discover.screen_operands = self._saved


@contextlib.contextmanager
def profiled(traced: bool):
    """``torch.profiler`` over the window, CPU and CUDA activity."""
    if not traced:
        yield None
        return
    import torch
    acts = [torch.profiler.ProfilerActivity.CPU,
            torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=acts) as prof:
        yield prof


class Context:
    """What a per-layer metric's reader reads (``metrics/<name>.py``):
    the window's libraries, its device trace, the screen's work, the
    card's integer peak and the window's seconds (from its start to the
    last library's end)."""

    def __init__(self, libraries, trace, screen, peak_ops, seconds=None):
        self.libraries = libraries
        self.trace = trace
        self.screen = screen
        self.peak_ops = peak_ops
        self.seconds = seconds


def reader(root: pathlib.Path, name: str):
    """The ``read(ctx)`` of the per-layer metric ``name``."""
    spec = importlib.util.spec_from_file_location(
        f"fusionbench_metric_{name}", find(root, "metrics", f"{name}.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.read


def check_libraries(cell, prepared, kept) -> list[dict]:
    """The compared numbers of each pooled library's last run."""
    genes = generator.Genes.load(prepared["genes"])
    readings = []
    for k, out in sorted(kept.items()):
        lib = load_truth(prepared["libs"][k]["truth"])
        exp = reference.expected(lib, genes, cell.cfg)
        obs = observe.read_run(out, genes, lib.n_pairs)
        nums = compare.numbers(obs, exp, genes)
        say(f"[check] library {k}: {json.dumps(nums)}")
        readings.append(nums)
    return readings


def start_prepare(args, root, cache, work) -> subprocess.Popen:
    """Set-up's data work (``prepare.py``) in a child process, kept off the
    card."""
    cmd = [sys.executable, str(HERE / "prepare.py"), "--workload",
           args.workload, "--seed", str(args.seed), "--work", str(work),
           "--root", str(root), "--cache", str(cache)]
    return subprocess.Popen(cmd, env=os.environ | {"CUDA_VISIBLE_DEVICES": ""})


def main(argv=None, *, require_card: bool = True, device: str = "cuda",
         root: pathlib.Path = ROOT, cache: pathlib.Path = CACHE) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)
    cell = Cell(args.workload, root)

    import torch
    if require_card and (not torch.cuda.is_available() or
                         torch.cuda.device_count() < cell.chips):
        say(f"fusionbench: {cell.chips} CUDA device(s) needed, "
            f"{torch.cuda.device_count() if torch.cuda.is_available() else 0}"
            " found")
        return 3
    base = os.environ.get("TMPDIR") or str(cache / "tmp")
    pathlib.Path(base).mkdir(parents=True, exist_ok=True)
    work = pathlib.Path(tempfile.mkdtemp(prefix="fusionbench-", dir=base))
    child = start_prepare(args, root, cache, work)
    try:
        import defuse_tpu_torch.cli.main  # noqa: F401  (the program)
        found = forbidden_modules()
        if found:
            say(f"fusionbench: forbidden modules loaded: {found}")
            return 4
        if child.wait():
            raise RuntimeError(f"prepare.py exited {child.returncode}")
        prepared = json.loads((work / "prepared.json").read_text())
        return _measure(args, cell, prepared, work, device)
    finally:
        if child.poll() is None:
            child.kill()
            child.wait()
        shutil.rmtree(work, ignore_errors=True)


@dataclasses.dataclass
class Window:
    """What a window did, as the report reads it."""
    libraries: list          # the finished libraries' records, in order
    kept: dict               # pool index: the output of its last run
    attempted: int
    failed: int
    seconds: float           # from its start to the last library's end
    rss_peak: int            # bytes
    mem_peak: int            # bytes on the fullest card
    trace: object = None     # devtrace.DeviceTrace of a traced window
    screen: object = None    # ScreenWork of a traced ``run`` window
    peak_ops: float | None = None


def _measure(args, cell, prepared, work, device) -> int:
    window = _cohort_window if cell.verb == "cohort" else _run_window
    got = window(args, cell, prepared, work, device)
    if isinstance(got, int):
        return got
    win, setup_s = got
    found = forbidden_modules()
    if found:
        say(f"fusionbench: forbidden modules loaded: {found}")
        return 4
    return _report(args, cell, prepared, win, setup_s, device)


def _run_window(args, cell, prepared, work, device):
    """The window of a ``run`` cell: the pool's libraries in turns through
    the port's command line in this process."""
    import torch
    config, dataset = prepared["config"], prepared["dataset"]
    traced = bool(args.trace)
    if device == "cuda":
        torch.cuda.reset_peak_memory_stats()
    rec = run_library(config, dataset, *prepared["warm"], work / "warm_out",
                      device)
    shutil.rmtree(work / "warm_out")
    say(f"[setup] warm-up library of {prepared['warm_pairs']} pairs: "
        f"{rec['seconds']:.3f} s; FASTQ written "
        f"{prepared['fastq_bytes']} bytes")
    peak_hz = roofline.max_sm_clock_hz() if device == "cuda" else None
    peak_ops = None if peak_hz is None else roofline.int_peak_ops(
        torch.cuda.get_device_properties(0).multi_processor_count, peak_hz)

    libraries, kept, passes, stale = [], {}, {}, []
    attempted = failed = 0
    screen = ScreenWork() if traced else contextlib.nullcontext()
    setup_s = time.perf_counter() - T_START
    with RssPeak() as rss, screen, profiled(traced) as prof, \
            span("window", traced):
        t_w0 = time.perf_counter()
        t_last = t_w0
        deadline = t_w0 + args.seconds
        while time.perf_counter() < deadline:
            k = attempted % 2
            out = work / f"out{attempted}"
            attempted += 1
            try:
                with span("library", traced):
                    rec = run_library(config, dataset,
                                      *prepared["libs"][k]["fq"], out,
                                      device)
            except Exception:
                failed += 1
                traceback.print_exc()
                stale.append(out)
                continue
            t_last = time.perf_counter()
            passes[k] = passes.get(k, 0) + 1
            rec |= {"pool": k, "pass": passes[k],
                    "pairs": prepared["libs"][k]["pairs"]}
            libraries.append(rec)
            if k in kept:
                stale.append(kept[k])
            kept[k] = out
            say(f"[library] {json.dumps(rec)}")
    window_s = t_last - t_w0
    say(f"[window] {len(libraries)} libraries in {window_s:.3f} s; "
        f"resident high-water mark {rss.start} bytes at the start, "
        f"{rss.peak} at the end (reset: {rss.reset}, raised: "
        f"{rss.raised})")
    for out in stale:                 # the harness's own file work, after
        shutil.rmtree(out, ignore_errors=True)
    mem_peak = torch.cuda.max_memory_allocated() if device == "cuda" else 0

    trace = None
    if prof is not None:
        events = devtrace.profiler_events(prof)
        win = [(s, e) for n, dev, s, e in events
               if not dev and n == devtrace.SPAN_PREFIX + "window"]
        trace = devtrace.analyse(events, win[0])
        # each library run's operations: those that start in its span
        runs = sorted((s, e) for n, dev, s, e in events if not dev and
                      n == devtrace.SPAN_PREFIX + "library")
        say_trace(trace, libraries, [
            (f"run {i + 1}, pool {i % 2}", devtrace.tally(
                [ev for ev in events if a <= ev[2] < b]))
            for i, (a, b) in enumerate(runs)])
    del prof

    if not rss.exact:
        say("fusionbench: the resident high-water mark was not reset and "
            "the window did not raise it above set-up's: no peak to read")
        return 5
    return Window(libraries, kept, attempted, failed, window_s, rss.peak,
                  mem_peak, trace, screen if traced else None,
                  peak_ops), setup_s


def say_trace(trace, libraries, parts) -> None:
    """The ``[trace]`` lines: the window's device time, its screen launches
    against the libraries that finished, and each library run's screen
    kernel and copies (``parts``: label, ``devtrace.tally``)."""
    screens = sum(n for k, n in trace.launches.items()
                  if "screen_kernel" in k)
    say(f"[trace] busy {trace.busy_s:.6f} s of {trace.window_s:.6f} s; "
        f"screen_kernel launches {screens} for {len(libraries)} finished "
        f"libraries; kernels {json.dumps(trace.kernels)}; launches "
        f"{json.dumps(trace.launches)}")
    for label, tally in parts:
        say(f"[trace] {label}: {json.dumps(tally)}")


def cohort_trace(profiles: pathlib.Path, libraries, attempted: int,
                 w0_ns: int, w1_ns: int):
    """The card's timeline over a cohort window from every library
    process's own profile under ``profiles``, on the epoch, from the
    window's start (``w0_ns``) to its end (``w1_ns``); None, said, where
    fewer profiles than library processes were found, since a partial
    timeline would misstate the idle share."""
    paths = sorted(profiles.rglob("trace.json"))
    if len(paths) < attempted:
        say(f"fusionbench: {len(paths)} library profiles for {attempted} "
            "library processes: the card's timeline is not read")
        return None
    names = {r["run"]: f"call {r['call']}, lib{r['pool']}"
             for r in libraries}
    events, parts = [], []
    for path in paths:
        got = devtrace.chrome_events(path, w0_ns)
        events += got
        parts.append((names.get(path.parent.name, path.parent.name),
                      devtrace.tally(got)))
    trace = devtrace.analyse(events, (0.0, (w1_ns - w0_ns) / 1e3))
    say_trace(trace, libraries, parts)
    first = min((ev[2] for ev in events), default=0.0) / 1e6
    last = max((ev[3] for ev in events), default=0.0) / 1e6
    say(f"[trace] the profiles' events lie {first:.6f} to {last:.6f} s "
        f"into the window of {trace.window_s:.6f} s")
    return trace


def _cohort_window(args, cell, prepared, work, device):
    """The window of a ``cohort`` cell: ``defuse cohort`` over the pool's
    manifest into a fresh directory, call after call until ``--seconds``
    have passed (``cohort.py``).  The warm-up is one such call over the
    warm-up library.  A traced window's calls each profile their library
    processes into a fresh directory (``cohort.profile_env``); the
    warm-up's and an untraced window's do not."""
    warm = cohort.call(cohort.command(prepared, prepared["warm_manifest"],
                                      work / "warm_out", 1, device))
    if warm.rc or cohort.read_call(work / "warm_out", ["warm"])["warm"] \
            is None:
        raise RuntimeError(f"the warm-up cohort call exited {warm.rc}")
    shutil.rmtree(work / "warm_out")
    say(f"[setup] warm-up cohort call of one library of "
        f"{prepared['warm_pairs']} pairs: {warm.seconds:.3f} s; FASTQ "
        f"written {prepared['fastq_bytes']} bytes")
    names = [f"lib{k}" for k in range(len(prepared["libs"]))]
    profiles = work / "profile"
    libraries, outs, recs = [], [], {}
    attempted = failed = rss_peak = 0
    setup_s = time.perf_counter() - T_START
    with cohort.CardMemory(device) as card:
        t_w0, w0_ns = time.perf_counter(), time.time_ns()
        t_last, w1_ns = t_w0, w0_ns
        deadline = t_w0 + args.seconds
        while time.perf_counter() < deadline:
            out = work / f"call{len(outs)}"
            outs.append(out)
            env = cohort.profile_env(profiles / out.name) if args.trace \
                else None
            got = cohort.call(cohort.command(prepared, prepared["manifest"],
                                             out, cell.workers, device), env)
            t_last, w1_ns = time.perf_counter(), time.time_ns()
            rss_peak = max(rss_peak, got.maxrss_bytes)
            recs = cohort.read_call(out, names)
            if got.rc:              # the user's command failed: none counts
                recs = dict.fromkeys(names)
            attempted += len(names)
            for k, name in enumerate(names):
                rec = recs[name]
                if rec is None:
                    failed += 1
                    continue
                rec |= {"pool": k, "call": len(outs),
                        "pairs": prepared["libs"][k]["pairs"]}
                libraries.append(rec)
                shown = {n: v for n, v in rec.items() if n != "spans"}
                say(f"[library] {json.dumps(shown)}")
            say(f"[call] {len(outs)}: exit {got.rc}, {got.seconds:.3f} s, "
                f"ru_maxrss {got.maxrss_bytes} bytes")
    window_s = t_last - t_w0
    kept = {k: outs[-1] / name for k, name in enumerate(names)
            if recs.get(name) is not None}
    say(f"[window] {len(libraries)} libraries in {len(outs)} cohort calls "
        f"in {window_s:.3f} s; the largest process's resident high-water "
        f"mark {rss_peak} bytes; card memory {card.peak} bytes over the "
        f"window's start")
    for out in outs[:-1]:             # the harness's own file work, after
        shutil.rmtree(out, ignore_errors=True)
    trace = None
    if args.trace:
        trace = cohort_trace(profiles, libraries, attempted, w0_ns, w1_ns)
        shutil.rmtree(profiles, ignore_errors=True)
    return Window(libraries, kept, attempted, failed, window_s, rss_peak,
                  card.peak or 0, trace), setup_s


def screened_on_device(rec, device) -> bool:
    """Whether a library's split-read screen ran on ``device``: the
    program's ``split_dp_impl`` says so, and a launch shows, counted in
    this process (a ``run`` cell on the card) or, where launches are not
    counted, as the candidates the program counts once the screen has
    returned."""
    impl = "cuda" if device == "cuda" else "torch"
    launched = rec["launches"].get("split_dp_screen") \
        if device == "cuda" and "launches" in rec else \
        rec["screen_candidates"]
    return rec["split_dp_impl"] == impl and bool(launched)


def screen_off_card(libraries, screen: str, device: str) -> int:
    """The libraries whose screen took another route than the mix asks
    for: under ``device``, those whose screen did not run on the card (0
    off the card); under ``auto``, those where the route taken is not the
    one the program records as its choice (``screen_route.choice``), or
    where it records none, or records a route forced by the program's
    ``DEFUSE_DEVICE_SCREEN`` (``screen_route.mode`` other than ``auto``)."""
    if screen == "device":
        return sum(not screened_on_device(r, device)
                   for r in libraries) if device == "cuda" else 0
    def off_choice(rec) -> bool:
        route = rec.get("screen_route") or {}
        taken = "device" if screened_on_device(rec, device) else "host"
        return route.get("mode") != "auto" or route.get("choice") != taken
    return sum(map(off_choice, libraries))


def _report(args, cell, prepared, win, setup_s, device) -> int:
    """Hold the kept libraries to the reference, and print the result."""
    import torch
    readings = check_libraries(cell, prepared, win.kept)
    off_card = screen_off_card(win.libraries, cell.screen, device)
    ok, worst = compare.judge(readings)
    checks = {k: {"value": worst.get(k), "limit": lim}
              for k, lim in compare.LIMITS.items()}
    checks["screen_off_card"] = {"value": off_card, "limit": 0}
    ok = ok and off_card == 0 and win.failed == 0 and bool(win.libraries)
    for k, v in checks.items():
        say(f"check {k}: {v['value']} (limit {v['limit']})")

    if args.trace:
        ctx = Context(win.libraries, win.trace, win.screen, win.peak_ops,
                      win.seconds)
        metrics = {}
        for name in cell.per_layer:
            value = reader(cell.root, name)(ctx)
            if value is not None:
                metrics[name] = {"value": value, "unit": cell.units[name]}
    else:
        metrics = {
            "peak_rss_gib": win.rss_peak / 2 ** 30,
            "setup_s": setup_s,
        }
        metrics = {k: {"value": v, "unit": cell.units[k]}
                   for k, v in metrics.items() if k in cell.end_to_end}
    result = {
        "correct": ok,
        "attempted": win.attempted,
        "failed": win.failed,
        "metrics": metrics,
        "device": {
            "platform": "gpu" if device == "cuda" else "cpu",
            "kind": torch.cuda.get_device_name(0) if device == "cuda"
            else "cpu",
            "count": cell.chips,
            "memory_peak_bytes": win.mem_peak,
        },
    }
    trace = win.trace
    if trace is not None:
        result["device"] |= {"busy_s": trace.busy_s,
                             "window_s": trace.window_s}
        result["breakdown"] = {
            "device_ops": sorted(([n, s] for n, s in trace.kernels.items()),
                                 key=lambda x: -x[1])[:10],
            "idle_gaps": [[n, s] for n, s in trace.gaps[:10]],
        }
    result["checks"] = checks
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
