"""Entry points: one forward step of the flagship compute path on the card,
and a dryrun of the discovery step on several processes.

Counterpart of ``__graft_entry__.py``:

``entry(device)``         — the flagship compute path's forward step: the
                            split-read DP row maxima of both flanks
                            (``rowmax_kernel`` on a CUDA device, the plain
                            PyTorch version on the CPU) and the split-score
                            combine;
``dryrun_multichip(n)``   — n processes in one gloo group on a data x inst
                            mesh run one discovery step: the split DP
                            sharded over ``data``, the batched EM over
                            ``inst``, the summary statistics merged with
                            ``all_reduce``; then the real discover with its
                            device stages (the EM's rows, the row maxima)
                            sharded over every rank, its artifacts
                            byte-identical to the one-process run.

Every rank computes on ``parallel.launch.rank_device(device)``: with one
card, all of them on ``cuda:0``.  Run as::

    python -m defuse_tpu_torch.entry [--device cpu]             # entry()
    python -m defuse_tpu_torch.entry dryrun [N] [--device cpu]  # N ranks (8)
"""

from __future__ import annotations

import json
import os
import pathlib
import sys
import time

import numpy as np
import torch

from .align.split_dp import accept_threshold
from .core.devices import require_cuda
from .ops.split_dp_batch import combine_split_scores, pad_batch
from .ops.split_dp_cuda import dp_row_maxima_cuda

DRYRUN_TIMEOUT_S = 600.0  # every rank's limit, and the gloo group's


def entry(device="cuda"):
    """Return (forward, example_args): the split-DP forward step and its
    operands (B 64, R 256, L 64, seeded) as tensors on ``device``."""
    dev = require_cuda(device)
    rng = np.random.default_rng(0)
    B, R, L = 64, 256, 64

    def mkseq(n):
        return "".join(rng.choice(list("ACGT"), n))

    ref1s = [mkseq(int(rng.integers(100, R))) for _ in range(B)]
    ref2s = [mkseq(int(rng.integers(100, R))) for _ in range(B)]
    reads = []
    for i in range(B):
        k = int(rng.integers(10, 40))
        reads.append(ref1s[i][:k] + ref2s[i][:50 - k])

    r1p, r1l = pad_batch(ref1s, R)
    r2p, r2l = pad_batch([s[::-1] for s in ref2s], R)
    rp, rl = pad_batch(reads, L)
    rrp, _ = pad_batch([s[::-1] for s in reads], L)
    min_scores = np.array([accept_threshold(len(r)) for r in reads],
                          dtype=np.int32)

    def forward(r1p, r1l, rp, rl, r2p, r2l, rrp, min_scores):
        rm1 = dp_row_maxima_cuda(r1p, r1l, rp, rl)
        rm2 = dp_row_maxima_cuda(r2p, r2l, rrp, rl)
        return combine_split_scores(rm1, rm2, rl, min_scores)

    example_args = tuple(torch.from_numpy(a).to(dev) for a in
                         (r1p, r1l, rp, rl, r2p, r2l, rrp, min_scores))
    return forward, example_args


def _free_port() -> int:
    import socket
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def dryrun_multichip(n_devices: int, device="cuda",
                     timeout=DRYRUN_TIMEOUT_S) -> dict:
    """One sharded discovery step on ``n_devices`` processes.

    Starts the ranks as child processes (``RANK``, ``WORLD_SIZE``,
    ``MASTER_ADDR``, a free ``MASTER_PORT``, and ``DEFUSE_NO_NATIVE=1`` so
    that the real discover takes the route with device stages; the
    caller's environment is left as it is), relays their output and waits
    for every one within ``timeout`` seconds.  A rank that fails or
    outlasts the limit ends the others and raises.  Returns each rank's
    report (mesh coordinates, device, the reduced values, seconds, kernel
    launches) and the wall seconds."""
    import shutil
    import subprocess
    import tempfile

    require_cuda(device)
    repo = pathlib.Path(__file__).resolve().parent.parent
    work = pathlib.Path(tempfile.mkdtemp(prefix="dryrun_"))
    port = _free_port()
    procs = []
    t0 = time.time()
    try:
        for rank in range(n_devices):
            env = dict(os.environ, RANK=str(rank),
                       WORLD_SIZE=str(n_devices), LOCAL_RANK=str(rank),
                       MASTER_ADDR="localhost", MASTER_PORT=str(port),
                       DEFUSE_NO_NATIVE="1")
            with open(work / f"rank{rank}.out", "w") as out, \
                    open(work / f"rank{rank}.err", "w") as err:
                procs.append(subprocess.Popen(
                    [sys.executable, "-m", "defuse_tpu_torch.entry",
                     "dryrun-rank", str(work), str(timeout), "--device",
                     str(device)], env=env, cwd=repo, stdout=out,
                    stderr=err))
        # wait until every rank has ended, one has failed, or time is up
        while any(p.poll() is None for p in procs) and \
                all(p.poll() in (None, 0) for p in procs) and \
                time.time() - t0 < timeout:
            time.sleep(0.1)
        failed = [r for r, p in enumerate(procs) if p.poll() != 0]
        for rank in range(n_devices):
            print((work / f"rank{rank}.out").read_text(), end="",
                  flush=True)
        if failed:
            rank = failed[0]
            why = "outlasted" if procs[rank].poll() is None else \
                f"exited {procs[rank].returncode} within"
            raise RuntimeError(
                f"dryrun rank {rank} of {n_devices} {why} the {timeout} s "
                f"limit:\n" + (work / f"rank{rank}.err").read_text()[-3000:])
        return {"seconds": time.time() - t0,
                "ranks": [json.loads((work / f"report.{r}.json").read_text())
                          for r in range(n_devices)]}
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
        shutil.rmtree(work, ignore_errors=True)


def _dryrun_rank(work, device, timeout) -> int:
    """One rank of ``dryrun_multichip``: the sharded step, then the real
    discover; writes ``report.<rank>.json`` under ``work``."""
    import torch.distributed as dist

    from .ops import split_dp_cuda
    from .parallel.launch import global_mesh, init_distributed, rank_device

    rank, n = init_distributed(timeout=timeout)
    dev = rank_device(device)
    split_dp_cuda.reset_launches()
    shape = (n // 2, 2) if n % 2 == 0 else (n, 1)
    mesh = global_mesh(inst_size=shape[1])
    t0 = time.time()
    step = _sharded_step(mesh, shape, dev)
    t_step = time.time() - t0
    real = _dryrun_real_discover(rank, n, dev, pathlib.Path(work))
    report = {"rank": rank, "world_size": n, "backend": dist.get_backend(),
              "device": str(dev),
              "mesh": {"data": mesh.get_local_rank("data"),
                       "inst": mesh.get_local_rank("inst"),
                       "shape": list(shape)},
              "step_s": t_step, **step, **real,
              "launches": dict(split_dp_cuda.LAUNCHES)}
    (pathlib.Path(work) / f"report.{rank}.json").write_text(
        json.dumps(report))
    dist.destroy_process_group()
    return 0


def _sharded_step(mesh, shape, dev) -> dict:
    """The reference's sharded step on this rank's slices: rank (d, i) runs
    the split DP on data slice d and the EM on instance slice i; the three
    ``psum``s are ``all_reduce``s over the mesh's groups."""
    import torch.distributed as dist

    from .cluster.matepair_em import EMParams
    from .cluster.matepair_em_batch import make_em_step, prepare_batch

    n_data, n_inst = shape
    d, i = mesh.get_local_rank("data"), mesh.get_local_rank("inst")

    # a BASELINE-config-2-shaped candidate screen: thousands of split
    # candidates (true junction reads + random decoys the DP must reject)
    # and EM bin-pair instances with real cluster structure
    rng = np.random.default_rng(1)
    Bdp = -(-2048 // n_data) * n_data  # divisible by the data axis
    R, L = 128, 64
    n_true = (Bdp * 3 // 4 // n_data) * n_data

    def mkseq(n):
        return "".join(rng.choice(list("ACGT"), n))

    ref1s = [mkseq(100) for _ in range(Bdp)]
    ref2s = [mkseq(100) for _ in range(Bdp)]
    reads = []
    for j in range(Bdp):
        if j < n_true:  # true junction read: flank1 suffix + flank2 prefix
            k = int(rng.integers(15, 36))
            reads.append(ref1s[j][:k] + ref2s[j][:50 - k])
        else:  # decoy: random sequence, rejected by the accept threshold
            reads.append(mkseq(50))
    r1p, r1l = pad_batch(ref1s, R)
    r2p, r2l = pad_batch([s[::-1] for s in ref2s], R)
    rp, rl = pad_batch(reads, L)
    rrp, _ = pad_batch([s[::-1] for s in reads], L)
    min_scores = np.array([accept_threshold(len(r)) for r in reads],
                          dtype=np.int32)

    params = EMParams(200.0, 20.0, 0.95, 3)
    instances = []
    for _ in range(32 * n_inst):
        # two breakpoint components per bin pair, fragment-length noise
        n = 24
        comps = rng.integers(1000, 5000, (2, 2)).astype(float)
        which = rng.integers(0, 2, n)
        xs = comps[which, 0] - rng.integers(0, 150, n)
        ys = comps[which, 1] - rng.integers(0, 150, n)
        us = np.full(n, 100.0)
        instances.append((xs, ys, us))
    batch = prepare_batch(instances, params, pad_n=32)

    # split DP on this rank's data slice
    per = Bdp // n_data

    def data_slice(a):
        return torch.from_numpy(np.ascontiguousarray(
            a[d * per:(d + 1) * per])).to(dev)

    rm1 = dp_row_maxima_cuda(*map(data_slice, (r1p, r1l, rp, rl)))
    rm2 = dp_row_maxima_cuda(*map(data_slice, (r2p, r2l, rrp, rl)))
    max_score, _best_k = combine_split_scores(rm1, rm2, data_slice(rl),
                                              data_slice(min_scores))
    accepted = (max_score > 0).sum().reshape(1).to(torch.int64).cpu()
    dist.all_reduce(accepted, group=mesh.get_group("data"))

    # EM on this rank's instance slice: the (instance, K) expansion padded
    # to a multiple of the inst axis, float32 as in the reference's step
    rows = batch.r0.shape[0]
    per_em = -(-rows // n_inst)

    def inst_slice(a, dtype=None, floor=None):
        a = np.pad(a, [(0, per_em * n_inst - rows)] + [(0, 0)] * (a.ndim - 1))
        if floor is not None:
            a = np.maximum(a, floor)
        a = np.ascontiguousarray(a[i * per_em:(i + 1) * per_em], dtype=dtype)
        return torch.from_numpy(a).to(dev)

    em_run = make_em_step(params.fragment_stddev)
    _a, _b, _w, ll, ok = em_run(
        inst_slice(batch.x, np.float32), inst_slice(batch.y, np.float32),
        inst_slice(batch.u, np.float32), inst_slice(batch.n, floor=1),
        inst_slice(batch.k, floor=1), inst_slice(batch.r0, np.float32))[:5]
    ll_sum = torch.where(ok, ll, 0.0).sum().reshape(1).to(
        torch.float64).cpu()
    dist.all_reduce(ll_sum, group=mesh.get_group("inst"))

    # fragment-length stats merge (merge_read_stats.pl contract)
    flen = data_slice(rl).to(torch.float32) * 4.0
    stats = torch.stack([flen.sum(), (flen * flen).sum(),
                         torch.tensor(float(flen.numel()), device=dev)]).cpu()
    dist.all_reduce(stats, group=mesh.get_group("data"))

    accepted, ll_sum = int(accepted), float(ll_sum)
    assert accepted == n_true, \
        f"expected {n_true} accepted (true junction reads), got {accepted}"
    assert stats[2] == Bdp, "stat count mismatch after all_reduce"
    assert np.isfinite(ll_sum), "EM log-likelihood not finite"
    if dist.get_rank() == 0:
        print(f"dryrun_multichip OK: mesh={{'data': {n_data}, 'inst': "
              f"{n_inst}}}, candidates={Bdp}, accepted={accepted} (decoys "
              f"rejected), em_instances={len(instances)}, "
              f"ll_sum={ll_sum:.3f}", flush=True)
    return {"accepted": accepted, "n_true": n_true, "candidates": Bdp,
            "em_instances": len(instances), "ll_sum": ll_sum}


def _gather_rows(t):
    """All ranks' equal-length row slices of ``t``, in rank order, as one
    numpy array."""
    import torch.distributed as dist
    t = t.contiguous().cpu()
    parts = [torch.empty_like(t) for _ in range(dist.get_world_size())]
    dist.all_gather(parts, t)
    return torch.cat(parts).numpy()


def _dryrun_real_discover(rank, n, dev, work) -> dict:
    """The real discover stage: rank 0 runs the one-process discover of a
    synthetic dataset (the batched EM and the row maxima on ``dev``); then
    every rank runs its device stages on its share of the rows, gathers
    the rest, and runs the same host tail (set cover, regions, evaluate)
    into a directory of its own.  Its ``clusters``, ``clusters.sc``,
    ``splitreads.break`` and ``splitreads.seq`` must be byte-identical to
    the one-process run's.  The EM is float64 without the exact re-solve on
    both sides: what ``run_batch`` picks by default."""
    from .align.batch_realign import collect_candidates, realign_candidates
    from .align.tasks import (SplitReadRealigner, create_tasks,
                              evaluate_file, read_align_region_pairs)
    from .cluster.discordant import (collect_bin_pair_tasks,
                                     emit_cluster_rows, write_clusters)
    from .cluster.matepair_em import EMParams
    from .cluster.matepair_em_batch import (make_em_step, prepare_batch,
                                            select_memberships)
    from .cluster.setcover import run_setcover_file
    from .core.exons import ExonRegions
    from .io.fasta import FastaStore
    from .io.sam import iter_compact, iter_sam, load_alignments
    from .parallel.launch import DistContext
    from .pipeline.discover import discover_fusions
    from .pipeline.regions import align_regions_lines
    from .utils.synth import make_dataset, write_dataset

    data = work / "data"
    paths = {k: data / v for k, v in (
        ("spanning", "spanning.compact"), ("improper", "improper.sam"),
        ("fastq1", "reads.1.fastq"), ("fastq2", "reads.2.fastq"),
        ("reference", "reference.fa"), ("exons", "cdna.regions"))}
    kw = {k: str(v) for k, v in paths.items()} | dict(
        fragment_mean=200.0, fragment_stddev=20.0, precision=0.95,
        min_cluster_size=3, min_read_length=50, max_read_length=50)
    params = EMParams(200.0, 20.0, 0.95, 3)
    t0 = time.time()
    if rank == 0:
        written = write_dataset(make_dataset(seed=5), data)
        assert all(written[k] == v for k, v in paths.items())
        discover_fusions(**kw, outdir=str(work / "single"), use_device=True,
                         em_mode="device", device=dev)
    DistContext(rank, n).barrier("dryrun_single_done")
    t_single = time.time() - t0
    single = work / "single"

    # --- the EM's rows, sharded over every rank -------------------------
    t0 = time.time()
    table = load_alignments(iter_compact(str(paths["spanning"])))
    tasks_em = collect_bin_pair_tasks(table, params)
    batch = prepare_batch([(t.x, t.y, t.u) for t in tasks_em], params)
    rows = len(batch.n)
    per = -(-rows // n)

    def my_rows(a, floor=None):
        a = np.pad(a, [(0, per * n - rows)] + [(0, 0)] * (a.ndim - 1))
        if floor is not None:
            a = np.maximum(a, floor)
        return torch.from_numpy(np.ascontiguousarray(
            a[rank * per:(rank + 1) * per])).to(dev)

    a, b, _w, ll, ok = make_em_step(params.fragment_stddev)(
        my_rows(batch.x), my_rows(batch.y), my_rows(batch.u),
        my_rows(batch.n, 1), my_rows(batch.k, 1), my_rows(batch.r0))[:5]
    a, b, ll = (_gather_rows(t)[:rows] for t in (a, b, ll))
    ok = _gather_rows(ok.to(torch.uint8))[:rows].astype(bool)
    memberships_map = select_memberships(batch, params, a, b, ll, ok,
                                         exact_resolve=False)
    memberships = [memberships_map.get(j, []) for j in range(len(tasks_em))]
    out = work / f"mesh{rank}"
    out.mkdir()
    write_clusters(emit_cluster_rows(tasks_em, memberships, table, params),
                   str(out / "clusters"))

    # --- host tail identical to discover_fusions ------------------------
    sc = out / "clusters.sc"
    run_setcover_file(str(out / "clusters"), str(sc), 3)
    regions = out / "clusters.sc.regions"
    regions.write_text("\n".join(align_regions_lines(
        sc.read_text().splitlines())) + "\n")
    tasks = create_tasks(FastaStore.from_file(str(paths["reference"])),
                         ExonRegions.from_file(str(paths["exons"])), 200.0,
                         20.0, 50, 50, read_align_region_pairs(str(regions)))
    realigner = SplitReadRealigner()
    for task in tasks.values():
        realigner.add_task(task)
    realigner.add_reads_fastq(str(paths["fastq1"]))
    realigner.add_reads_fastq(str(paths["fastq2"]))
    candidates = collect_candidates(realigner,
                                    iter_sam(str(paths["improper"])))

    def rowmax_sharded(refs_p, ref_lens, reads_p, read_lens):
        """Split-DP row maxima: this rank's rows on ``dev``, gathered."""
        B = refs_p.shape[0]
        per_dp = -(-B // n)

        def mine(arr):
            arr = np.pad(arr, [(0, per_dp * n - B)]
                         + [(0, 0)] * (arr.ndim - 1))
            return torch.from_numpy(np.ascontiguousarray(
                arr[rank * per_dp:(rank + 1) * per_dp])).to(dev)

        return _gather_rows(dp_row_maxima_cuda(
            mine(refs_p), mine(ref_lens.astype(np.int32)), mine(reads_p),
            mine(read_lens.astype(np.int32))))[:B]

    split_rows = realign_candidates(realigner, candidates, rowmax_sharded,
                                    device=dev)
    split_path = out / "splitreads.alignments"
    with open(split_path, "w") as fh:
        for row in split_rows:
            fh.write(row.format() + "\n")
    lines = split_path.read_text().splitlines(keepends=True)
    lines.sort(key=lambda l: (int(l.split("\t", 1)[0]), l.encode()))
    sorted_path = out / "splitreads.alignments.sorted"
    sorted_path.write_text("".join(lines))
    outs = {name: out / f"splitreads.{name}"
            for name in ("seq", "break", "predalign")}
    with open(outs["seq"], "w") as seq_out, \
            open(outs["break"], "w") as break_out, \
            open(outs["predalign"], "w") as pred_out:
        evaluate_file(tasks, str(sorted_path), seq_out, break_out, pred_out)
    t_sharded = time.time() - t0

    # byte-identity and counts against the one-process run
    for name in ("clusters", "clusters.sc", "splitreads.break",
                 "splitreads.seq"):
        assert (out / name).read_bytes() == (single / name).read_bytes(), \
            f"rank {rank}: sharded {name} differs from the one-process run"
    n_clusters = len({line.split("\t", 1)[0] for line in
                      open(out / "clusters")})
    n_breaks = sum(1 for _ in open(outs["break"]))
    assert n_breaks > 0, "the real discover called no break"
    if rank == 0:
        print(f"dryrun real-discover OK: {n_clusters} clusters, {n_breaks} "
              f"break rows — {n} ranks == one process (byte-identical "
              f"clusters/sc/break/seq)", flush=True)
    return {"single_s": t_single, "sharded_s": t_sharded,
            "em_rows": rows, "rowmax_instances": 2 * len(candidates),
            "n_clusters": n_clusters, "n_breaks": n_breaks}


def main(argv=None) -> int:
    import argparse
    p = argparse.ArgumentParser(prog="python -m defuse_tpu_torch.entry")
    p.add_argument("command", nargs="?", default="entry",
                   choices=("entry", "dryrun", "dryrun-rank"))
    p.add_argument("args", nargs="*",
                   help="dryrun: the number of ranks (8)")
    p.add_argument("--device", choices=("cuda", "cpu"), default="cuda")
    args = p.parse_args(argv)
    if args.command == "dryrun":
        dryrun_multichip(int(args.args[0]) if args.args else 8, args.device)
    elif args.command == "dryrun-rank":
        return _dryrun_rank(args.args[0], args.device, float(args.args[1]))
    else:
        fn, fn_args = entry(args.device)
        out = fn(*fn_args)
        print("entry OK:", [tuple(o.shape) for o in out])
    return 0


if __name__ == "__main__":
    sys.exit(main())
