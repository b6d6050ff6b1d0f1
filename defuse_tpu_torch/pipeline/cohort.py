"""Multi-library cohort orchestration.

The reference runs deFuse once per library (``defuse_run.pl:51-66``
takes exactly one -1/-2 pair); a production cohort — the BASELINE
deployment shape is 8+ tumour libraries on a v5p-32/64 pod — needs a
launcher that fans libraries out across hosts, shares the one-time
reference artifacts, survives restarts, and summarizes fusions
cohort-wide (recurrence across libraries is the clinical signal a
cohort exists for).

Design (one process per library, not a cluster-submitter translation):

* a *manifest* lists the libraries (TSV ``name fastq1 fastq2`` or a
  JSON array of objects); the dataset/reference is built once with
  ``create-ref`` and mmap-shared by every library run on a host;
* fan-out is static round-robin by rank — library ``i`` belongs to
  process ``i % nprocs`` (rank from DEFUSE_COHORT_RANK/NPROCS, falling
  back to the JAX_PROCESS_ID/JAX_NUM_PROCESSES pair a launcher of the
  reference package may have set).  Static ownership keeps restarts
  deterministic and needs no coordinator for the library-level
  parallelism;
* each library runs in its own subprocess (``python -m defuse_tpu_torch
  run --device <device>``) so one library's failure cannot take down the
  cohort; within a rank, ``workers`` libraries run concurrently.  The
  children inherit ``CUDA_VISIBLE_DEVICES``: with ``workers > 1`` they
  share the card;
* restartability: a library whose ``results.filtered.tsv`` exists is
  skipped (the per-stage mtime skip inside ``pipeline.runner`` covers
  partial reruns of an unfinished library);
* every rank writes ``cohort_summary.rank<r>.tsv``; rank 0 merges the
  shards into ``cohort_summary.tsv``, ``cohort_fusions.tsv`` (all
  filtered fusions with a leading ``library`` column) and
  ``cohort_recurrent.tsv`` (gene-pair x library recurrence, descending).
"""

from __future__ import annotations

import dataclasses
import json
import os
import pathlib
import subprocess
import sys
import time


@dataclasses.dataclass
class Library:
    name: str
    fastq1: str
    fastq2: str
    bam: str | None = None


def read_manifest(path: str) -> list[Library]:
    """TSV (``name<TAB>fastq1<TAB>fastq2``, ``#`` comments) or a JSON
    array of {name, fastq1, fastq2} / {name, bam} objects."""
    p = pathlib.Path(path)
    text = p.read_text()
    libs: list[Library] = []
    if text.lstrip().startswith("["):
        for obj in json.loads(text):
            libs.append(Library(obj["name"], obj.get("fastq1", ""),
                                obj.get("fastq2", ""), obj.get("bam")))
    else:
        for line in text.splitlines():
            line = line.strip()
            if not line or line.startswith("#"):
                continue
            fields = line.split("\t")
            if len(fields) == 2:
                libs.append(Library(fields[0], "", "", fields[1]))
            elif len(fields) >= 3:
                libs.append(Library(fields[0], fields[1], fields[2]))
            else:
                raise ValueError(f"manifest line needs 2 or 3 fields: "
                                 f"{line!r}")
    names = [lb.name for lb in libs]
    if len(set(names)) != len(names):
        raise ValueError("duplicate library names in manifest")
    return libs


def _rank_nprocs() -> tuple[int, int]:
    env = os.environ
    if "DEFUSE_COHORT_RANK" in env:
        return (int(env["DEFUSE_COHORT_RANK"]),
                int(env.get("DEFUSE_COHORT_NPROCS", "1")))
    if "JAX_PROCESS_ID" in env and "JAX_NUM_PROCESSES" in env:
        return int(env["JAX_PROCESS_ID"]), int(env["JAX_NUM_PROCESSES"])
    return 0, 1


def run_cohort(config: str, dataset: str, manifest: str, outdir: str,
               workers: int = 1, use_device: bool = True,
               merge_timeout_s: float = 24 * 3600.0,
               device: str = "cuda") -> dict:
    """Run every manifest library through the pipeline; merge on rank 0.
    Each library's device stages run on ``device`` ("cuda", or "cpu" for
    their plain versions); asking for a card that is absent raises here,
    before any library starts.

    Returns {"summary": path, "fusions": path, "recurrent": path} on
    rank 0, {} on other ranks.
    """
    if use_device:
        from ..core.devices import require_cuda
        require_cuda(device)
    libs = read_manifest(manifest)
    rank, nprocs = _rank_nprocs()
    out = pathlib.Path(outdir)
    out.mkdir(parents=True, exist_ok=True)

    # Stale-shard guard: summary shards persist across runs, so a
    # RESUME could otherwise let rank 0 merge a previous run's shards
    # while other ranks are still recomputing (observed: a recomputed
    # library read mid-run broke the cohort_fusions byte-identity
    # contract).  Each rank drops its own stale shard immediately;
    # when the launcher provides DEFUSE_COHORT_RUN_ID (identical for
    # every rank — scheduler job id, timestamp, anything shared), the
    # shard embeds it and rank 0 accepts only matching shards, which
    # closes the race completely.  Without a run id the unlink keeps
    # the window to the few ms between launch and this line.
    run_id = os.environ.get("DEFUSE_COHORT_RUN_ID", "")
    (out / f"cohort_summary.rank{rank}.tsv").unlink(missing_ok=True)

    mine = [(i, lb) for i, lb in enumerate(libs) if i % nprocs == rank]
    rows = []
    pending: list[tuple[subprocess.Popen, Library, float]] = []

    def harvest(proc, lb, t0):
        res = out / lb.name / "results.filtered.tsv"
        ok = proc.returncode == 0 and res.exists()
        n = max(0, len(res.read_text().splitlines()) - 1) if ok else 0
        rows.append((lb.name, "ok" if ok else "failed", n,
                     round(time.time() - t0, 1), str(res if ok else "")))
        if not ok:
            sys.stderr.write(f"cohort: library {lb.name} failed "
                             f"(rc={proc.returncode})\n")

    for _i, lb in mine:
        libdir = out / lb.name
        res = libdir / "results.filtered.tsv"
        if res.exists():
            n = max(0, len(res.read_text().splitlines()) - 1)
            rows.append((lb.name, "cached", n, 0.0, str(res)))
            continue
        cmd = [sys.executable, "-m", "defuse_tpu_torch", "run",
               "-c", config, "-d", dataset, "-o", str(libdir),
               "-n", lb.name]
        if lb.bam:
            cmd += ["--bam", lb.bam]
        else:
            cmd += ["-1", lb.fastq1, "-2", lb.fastq2]
        cmd += ["--device", str(device)]
        if not use_device:
            cmd += ["--no-device"]
        while len(pending) >= max(1, workers):
            proc, plb, t0 = pending.pop(0)
            proc.wait()
            harvest(proc, plb, t0)
        libdir.mkdir(parents=True, exist_ok=True)
        log = open(libdir / "cohort.log", "w")
        pending.append((subprocess.Popen(cmd, stdout=log, stderr=log),
                        lb, time.time()))
    for proc, plb, t0 in pending:
        proc.wait()
        harvest(proc, plb, t0)

    shard = out / f"cohort_summary.rank{rank}.tsv"
    tmp = shard.with_suffix(".tmp")
    with open(tmp, "w") as fh:
        fh.write(f"#run_id={run_id}\n")
        for r in sorted(rows):
            fh.write("\t".join(map(str, r)) + "\n")
    tmp.rename(shard)  # atomic: the merger never sees a partial shard

    if rank != 0:
        return {}
    return merge_cohort(outdir, nprocs, libs, timeout_s=merge_timeout_s,
                        run_id=run_id)


def merge_cohort(outdir: str, nprocs: int, libs: list[Library],
                 timeout_s: float = 24 * 3600.0,
                 run_id: str = "") -> dict:
    """Rank 0: wait for every rank's summary shard — from THIS run when
    a run id is in force (stale shards from a previous run are not
    accepted) — then write the cohort summary, the pooled fusion
    table, and the recurrence table."""
    out = pathlib.Path(outdir)
    deadline = time.time() + timeout_s
    shards = [out / f"cohort_summary.rank{r}.tsv" for r in range(nprocs)]

    def fresh(s: pathlib.Path) -> bool:
        if not s.exists():
            return False
        if not run_id:
            return True
        try:
            with open(s) as fh:
                return fh.readline().strip() == f"#run_id={run_id}"
        except OSError:
            return False

    while not all(fresh(s) for s in shards):
        if time.time() > deadline:
            missing = [str(s) for s in shards if not fresh(s)]
            raise TimeoutError(
                f"cohort merge: missing/stale {missing}")
        time.sleep(2.0)

    summary = out / "cohort_summary.tsv"
    with open(summary, "w") as fh:
        fh.write("library\tstatus\tn_fusions\telapsed_s\tresults\n")
        lines = []
        for s in shards:
            lines += [ln for ln in s.read_text().splitlines()
                      if not ln.startswith("#")]
        order = {lb.name: i for i, lb in enumerate(libs)}
        lines.sort(key=lambda ln: order.get(ln.split("\t", 1)[0], 1 << 30))
        fh.write("\n".join(lines) + ("\n" if lines else ""))

    fusions = out / "cohort_fusions.tsv"
    pair_libs: dict[tuple[str, str], set] = {}
    header_written = False
    with open(fusions, "w") as fh:
        for lb in libs:
            res = out / lb.name / "results.filtered.tsv"
            if not res.exists():
                continue
            rl = res.read_text().splitlines()
            if not rl:
                continue
            header = rl[0].split("\t")
            if not header_written:
                fh.write("library\t" + rl[0] + "\n")
                header_written = True
            g1 = header.index("gene1")
            g2 = header.index("gene2")
            for row in rl[1:]:
                fh.write(lb.name + "\t" + row + "\n")
                f = row.split("\t")
                key = tuple(sorted((f[g1], f[g2])))
                pair_libs.setdefault(key, set()).add(lb.name)

    recurrent = out / "cohort_recurrent.tsv"
    with open(recurrent, "w") as fh:
        fh.write("gene1\tgene2\tn_libraries\tlibraries\n")
        for key, who in sorted(pair_libs.items(),
                               key=lambda kv: (-len(kv[1]), kv[0])):
            fh.write(f"{key[0]}\t{key[1]}\t{len(who)}\t"
                     f"{','.join(sorted(who))}\n")
    return {"summary": str(summary), "fusions": str(fusions),
            "recurrent": str(recurrent)}
