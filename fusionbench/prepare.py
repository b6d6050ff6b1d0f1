"""A cell of ``BENCHMARK.json``, and set-up's data work in a process of its
own: the configuration's reference dataset (built once into
``build/fusionbench/ref/``, keyed by the configuration file and
``generator.py``), the pool's libraries (two; a cohort configuration's
``cohort.libraries``) and the warm-up library as paired FASTQ, with a
manifest of each for ``defuse cohort``, and each pooled library's truth
for the check.  ``run.py`` starts it beside its own imports, so that the
memory the generator takes never counts in the run's resident high-water
mark.

    python3 fusionbench/prepare.py --workload wts50.dense --seed 7 \
        --work <dir>

writes ``<dir>/prepared.json``.  Runs none of the program but
``create-ref``, and that only where the dataset is not built yet; it is
kept off the card.
"""

import argparse
import hashlib
import json
import os
import pathlib
import shutil
import sys
import time

HERE = pathlib.Path(__file__).resolve().parent
ROOT = HERE.parent
CACHE = ROOT / "build" / "fusionbench"
WARMUP_PAIRS = 30_000

if str(HERE) not in sys.path:
    sys.path.insert(0, str(HERE))

import numpy as np  # noqa: E402

import generator  # noqa: E402


def find(root: pathlib.Path, kind: str, file: str) -> pathlib.Path:
    """A file of the benchmark's data by name: ``fusionbench/<kind>/<file>``
    under ``root`` (the checkout, or a test's tree), else beside this
    script."""
    path = root / HERE.name / kind / file
    return path if path.exists() else HERE / kind / file


VERBS = ("run", "cohort")
SCREENS = ("device", "auto")


class Cell:
    """A workload of ``BENCHMARK.json`` with its configuration and mix.

    The configuration's ``verb`` (``run`` where it has none) is how the
    window drives the program: ``run``, a library at a time in the
    harness's process, or ``cohort``, ``cohort.libraries`` libraries a call
    of ``defuse cohort`` with ``cohort.workers`` library processes at once.
    The mix's ``screen`` (``device`` where it has none) is the route its
    libraries' split-read screen must take: the card's, or the one the
    program records as its own choice (``auto``)."""

    def __init__(self, name: str, root: pathlib.Path = ROOT):
        bench = json.loads((root / "BENCHMARK.json").read_text())
        work = {w["name"]: w for w in bench["workloads"]}
        if name not in work:
            raise SystemExit(f"no workload {name!r} in BENCHMARK.json")
        self.workload = work[name]
        conf = {c["name"]: c for c in bench["configs"]}[
            self.workload["config"]]
        self.config_file = root / conf["file"]
        self.cfg = generator.load_json(self.config_file)
        self.mix = generator.load_json(
            find(root, "traffic", f"{self.workload['traffic']}.json"))
        self.root = root
        self.chips = int(self.workload["chips"])
        self.per_layer = [m["name"] for m in bench["per_layer"]
                          if name in m.get("workloads", [name])]
        self.end_to_end = {m["name"]: m for m in bench["end_to_end"]
                           if name in m.get("workloads", [name])}
        self.units = {m["name"]: m["unit"] for m in
                      bench["end_to_end"] + bench["per_layer"]}
        self.verb = self.cfg.get("verb", "run")
        cohort = self.cfg.get("cohort", {})
        self.n_libraries = int(cohort.get("libraries", 2))
        self.workers = int(cohort.get("workers", 1))
        self.screen = self.mix.get("screen", "device")
        if self.verb not in VERBS or self.screen not in SCREENS or \
                self.n_libraries < 1 or self.workers < 1:
            raise SystemExit(
                f"{name}: verb {self.verb!r} (one of {VERBS}), screen "
                f"{self.screen!r} (one of {SCREENS}), cohort {cohort!r}")


def library_seeds(seed: int, n_pool: int = 2) -> list[int]:
    """Seeds of the pool's ``n_pool`` libraries, then of the warm-up
    library: the children of ``SeedSequence(seed).spawn`` keep their index,
    so the first two pooled libraries are children 0 and 1 and the warm-up
    child 2 at every ``n_pool``, and further pooled libraries children 3
    on."""
    ss = np.random.SeedSequence(seed)
    kids = [int(s.generate_state(1, np.uint64)[0])
            for s in ss.spawn(max(3, n_pool + 1))]
    pool = (kids[:2] + kids[3:])[:n_pool]
    return pool + [kids[2]]


def reference_dataset(cell: Cell, cache: pathlib.Path = CACHE):
    """The configuration's genome inputs and ``create-ref`` dataset, built
    once into a directory keyed by the configuration file and the
    generator's code.  Returns (config.txt, dataset dir, inputs dir,
    seconds spent building, 0 when it was there)."""
    key = hashlib.sha256(cell.config_file.read_bytes() +
                         (HERE / "generator.py").read_bytes()).hexdigest()
    where = cache / "ref" / f"{cell.cfg['name']}-{key[:16]}"
    inputs, dataset = where / "inputs", where / "dataset"
    t0 = time.perf_counter()
    built = 0.0
    if not (where / "done").exists():
        shutil.rmtree(where, ignore_errors=True)
        generator.write_reference_inputs(cell.cfg, inputs)
        config = generator.write_run_config(inputs)
        if str(ROOT) not in sys.path:
            sys.path.insert(1, str(ROOT))
        from defuse_tpu_torch.cli.main import main as cli
        if cli(["create-ref", "-c", str(config), "-d", str(dataset)]):
            raise RuntimeError("create-ref failed")
        (where / "done").write_text(key + "\n")
        built = time.perf_counter() - t0
    config = generator.write_run_config(inputs)
    return config, dataset, inputs, built


def save_truth(lib: generator.Library, path: pathlib.Path) -> None:
    fus = lib.fusions
    np.savez(path, read_len=lib.read_len, kind=lib.kind, fusion=lib.fusion,
             gene=lib.gene, start=lib.start, flen=lib.flen, side=lib.side,
             fus_a=fus.a, fus_b=fus.b, break_a=fus.break_a,
             break_b=fus.break_b)


def load_truth(path) -> generator.Library:
    z = np.load(path)
    fus = generator.Fusions(z["fus_a"], z["fus_b"], z["break_a"],
                            z["break_b"])
    return generator.Library(int(z["read_len"]), z["kind"], z["fusion"],
                             z["gene"], z["start"], z["flen"], z["side"],
                             fus)


def prepare(cell: Cell, seed: int, work: pathlib.Path,
            cache: pathlib.Path = CACHE) -> dict:
    """Everything a run reads before its warm-up, as ``prepared.json``
    gives it to ``run.py``."""
    config, dataset, inputs, built = reference_dataset(cell, cache)
    print(f"[setup] reference dataset {dataset} "
          f"({'built in %.1f s' % built if built else 'cached'})")
    genes = generator.Genes.load(inputs / "genes.npz")
    *pool, s_warm = library_seeds(seed, cell.n_libraries)
    libs, written = [], 0
    for k, s in enumerate(pool):
        lib = generator.make_library(cell.cfg, cell.mix, genes, s)
        fq1, fq2, n = generator.write_library(lib, genes, s, work / f"lib{k}")
        save_truth(lib, work / f"lib{k}" / "truth.npz")
        written += n
        libs.append({"fq": [str(fq1), str(fq2)], "pairs": lib.n_pairs,
                     "truth": str(work / f"lib{k}" / "truth.npz")})
    warm = generator.make_library(cell.cfg, cell.mix, genes, s_warm,
                                  WARMUP_PAIRS)
    wfq1, wfq2, n = generator.write_library(warm, genes, s_warm,
                                            work / "warm")
    written += n
    out = {"config": str(config), "dataset": str(dataset),
           "genes": str(inputs / "genes.npz"), "built_s": built,
           "fastq_bytes": written, "libs": libs,
           "warm": [str(wfq1), str(wfq2)], "warm_pairs": WARMUP_PAIRS}
    if cell.verb == "cohort":
        out["manifest"] = str(write_manifest(
            work / "pool.tsv", [(f"lib{k}", *lb["fq"])
                                for k, lb in enumerate(libs)]))
        out["warm_manifest"] = str(write_manifest(
            work / "warm.tsv", [("warm", str(wfq1), str(wfq2))]))
    return out


def write_manifest(path: pathlib.Path, rows) -> pathlib.Path:
    """A ``defuse cohort`` manifest: ``name<TAB>fastq1<TAB>fastq2`` a
    library."""
    path.write_text("".join("\t".join(map(str, r)) + "\n" for r in rows))
    return path


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--work", type=pathlib.Path, required=True)
    ap.add_argument("--root", type=pathlib.Path, default=ROOT)
    ap.add_argument("--cache", type=pathlib.Path, default=CACHE)
    args = ap.parse_args(argv)
    out = prepare(Cell(args.workload, args.root), args.seed, args.work,
                  args.cache)
    (args.work / "prepared.json").write_text(json.dumps(out))
    return 0


if __name__ == "__main__":
    os.dup2(2, 1)           # nothing of the child's reaches the result's line
    sys.exit(main())
