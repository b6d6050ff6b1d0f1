"""Incremental stage runner — the ``cmdrunner.pm`` equivalent.

A make-like artifact-addressed runner: each stage declares inputs and
outputs; a stage is skipped when every output exists and is newer than
every input (``cmdrunner.pm:836-889``); outputs are written to ``.tmp``
paths and atomically renamed on success (``cmdrunner.pm:535-540``);
failed stages delete their partial outputs (``cmdrunner.pm:818-822``).
Stages are Python callables or argv lists; parallel stages fan out over a
process/thread pool.  Per-stage wall-clock is logged in the reference's
``[timestamp] name [N sec]`` format for cross-tool debugging.

This gives the same restartable-DAG contract the reference relies on for
checkpoint/resume: rerunning a pipeline skips completed stages.
"""

from __future__ import annotations

import concurrent.futures
import os
import pathlib
import subprocess
import time
from datetime import datetime


class StageError(RuntimeError):
    pass


class Runner:
    def __init__(self, log_dir: str, name: str = "defuse-tpu",
                 max_parallel: int = 1):
        self.log_dir = pathlib.Path(log_dir)
        self.log_dir.mkdir(parents=True, exist_ok=True)
        self.name = name
        self.max_parallel = max_parallel
        self.log_path = self.log_dir / f"{name}.log"
        self._batch: list[tuple] = []

    # -- logging ---------------------------------------------------------

    def _log(self, message: str) -> None:
        stamp = datetime.now().strftime("%a %b %e %H:%M:%S %Y")
        with open(self.log_path, "a") as fh:
            fh.write(f"[{stamp}] {message}\n")

    def _announce(self, message: str) -> None:
        stamp = datetime.now().strftime("%a %b %e %H:%M:%S %Y")
        print(f"[{stamp}] {message}", flush=True)

    # -- up-to-date check ------------------------------------------------

    @staticmethod
    def _uptodate(inputs, outputs) -> bool:
        if not outputs:
            return False
        try:
            out_mtimes = [os.path.getmtime(o) for o in outputs]
        except OSError:
            return False
        in_mtimes = [os.path.getmtime(i) for i in inputs if
                     os.path.exists(i)]
        if len(in_mtimes) != len(list(inputs)):
            return False
        return not in_mtimes or min(out_mtimes) >= max(in_mtimes)

    # -- execution -------------------------------------------------------

    def run(self, name, fn, inputs=(), outputs=()) -> bool:
        """Run one stage; fn(tmp_outputs) -> None, or an argv list where
        occurrences of output paths are replaced by tmp paths.  Returns
        True if the stage ran, False if skipped up-to-date."""
        inputs = [str(p) for p in inputs]
        outputs = [str(p) for p in outputs]
        if self._uptodate(inputs, outputs):
            self._log(f"skipping {name}: up to date")
            return False

        # keep a .gz extension LAST on the tmp name: stage writers pick
        # their compression from the path they are handed (e.g. the
        # covariance-sample writers), so "<x>.gz" becomes "<x>.tmp.gz",
        # not "<x>.gz.tmp"
        tmp_outputs = [o[:-3] + ".tmp.gz" if o.endswith(".gz")
                       else o + ".tmp" for o in outputs]
        start = time.time()
        try:
            if callable(fn):
                fn(tmp_outputs)
            else:
                argv = [str(a) for a in fn]
                argv = [a if a not in outputs
                        else tmp_outputs[outputs.index(a)] for a in argv]
                proc = subprocess.run(argv, capture_output=True, text=True)
                if proc.returncode != 0:
                    raise StageError(
                        f"{name}: exit {proc.returncode}\n{proc.stderr}")
            for tmp, out in zip(tmp_outputs, outputs):
                if not os.path.exists(tmp):
                    raise StageError(f"{name}: missing output {out}")
                os.replace(tmp, out)
        except BaseException:
            for tmp in tmp_outputs:
                if os.path.exists(tmp):
                    os.unlink(tmp)
            for out in outputs:
                if os.path.exists(out):
                    os.unlink(out)
            self._log(f"failed {name}")
            raise
        elapsed = int(time.time() - start)
        self._log(f"{name} [{elapsed} sec]")
        self._announce(f"{name} [{elapsed} sec]")
        return True

    # -- parallel batches (padd/prun, cmdrunner.pm:418-443) --------------

    def padd(self, name, fn, inputs=(), outputs=()) -> None:
        self._batch.append((name, fn, inputs, outputs))

    def prun(self) -> None:
        batch, self._batch = self._batch, []
        if not batch:
            return
        if self.max_parallel <= 1 or len(batch) == 1:
            for stage in batch:
                self.run(*stage)
            return
        with concurrent.futures.ThreadPoolExecutor(
                max_workers=self.max_parallel) as pool:
            futures = [pool.submit(self.run, *stage) for stage in batch]
            for f in futures:
                f.result()
