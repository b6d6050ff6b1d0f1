"""The port's multi-process path on the CPU: real two-process
``torch.distributed`` runs of ``defuse_tpu_torch/parallel/launch.py``.

Modelled on ``tests/test_distributed_launch.py`` and
``tests/test_launch_gather.py``: the ranks are OS processes
(``tests/torch_dist_*worker.py``, which import no ``jax``) in one gloo group
on a free port, each with a finite limit on its collectives, each waited on
with a limit and killed when it runs over.  The group forms from torchrun's
variables or the reference launcher's; the mesh has its shape and names;
the cross-process read-stats merges equal the sequential ones, and 64-bit
payloads come back bit for bit; a barrier whose names differ raises on
every rank; the two-process ``run`` equals the one-process run of the port
and of ``defuse_tpu`` byte for byte; a rank-0 failure ends every rank."""

import json
import os
import pathlib
import socket
import subprocess
import sys

import numpy as np
import pytest

from defuse_tpu_torch.cluster import native

from test_torch_sharded import indices, package, references, run_kwargs
from torch_dist_worker import F64, NAN_BITS, U64, synth_sam

REPO = pathlib.Path(__file__).resolve().parent.parent
TESTS = REPO / "tests"
N_PAIRS, SEED = 500, 42
LAUNCH_VARS = ("RANK", "WORLD_SIZE", "LOCAL_RANK", "MASTER_ADDR",
               "MASTER_PORT", "JAX_COORDINATOR", "JAX_NUM_PROCESSES",
               "JAX_PROCESS_ID", "JAX_AUTO_DISTRIBUTED")


def _free_port():
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def launch_env(pid, n, port, launcher):
    env = {k: v for k, v in os.environ.items() if k not in LAUNCH_VARS}
    env["OMP_NUM_THREADS"] = "1"  # small tensors: threads only contend
    if launcher == "torchrun":
        env.update(RANK=str(pid), WORLD_SIZE=str(n), MASTER_ADDR="localhost",
                   MASTER_PORT=str(port))
    else:
        env.update(JAX_COORDINATOR=f"localhost:{port}",
                   JAX_NUM_PROCESSES=str(n), JAX_PROCESS_ID=str(pid))
    return env


def run_ranks(args, limit, n=2, launcher="torchrun"):
    """Start ``n`` ranks of ``python args...``; [(exit code, stdout,
    stderr)] in rank order.  A rank still running after ``limit`` seconds
    fails the test, every rank killed."""
    port = _free_port()
    procs = [subprocess.Popen(
        [sys.executable, *map(str, args)],
        env=launch_env(pid, n, port, launcher), cwd=REPO, text=True,
        stdout=subprocess.PIPE, stderr=subprocess.PIPE) for pid in range(n)]
    outs = []
    for pid, p in enumerate(procs):
        try:
            outs.append(p.communicate(timeout=limit))
        except subprocess.TimeoutExpired:
            for q in procs:
                q.kill()
                q.communicate()
            pytest.fail(f"rank {pid} still running after {limit} s")
    return [(p.returncode, out, err) for p, (out, err) in zip(procs, outs)]


def reports(results, tmp_path):
    for pid, (rc, _out, err) in enumerate(results):
        assert rc == 0, (pid, err[-3000:])
    return [json.loads((tmp_path / f"report.{pid}.json").read_text())
            for pid in range(len(results))]


def worker(mode, tmp_path, *args, limit=240, launcher="torchrun"):
    return run_ranks([TESTS / "torch_dist_worker.py", mode, tmp_path, *args],
                     limit, launcher=launcher)


@pytest.mark.parametrize("launcher", ["torchrun", "jax"])
def test_two_process_distributed_launch(tmp_path, launcher):
    results = worker("launch", tmp_path, N_PAIRS, SEED, launcher=launcher)
    reps = reports(results, tmp_path)
    for pid, rep in enumerate(reps):
        assert rep["pid"] == pid and rep["n_proc"] == 2
        assert rep["backend"] == "gloo"
        assert rep["mesh_shape"] == [2, 1]
        assert rep["mesh_names"] == ["data", "inst"]

    # every process saw the same merged stats, equal to the sequential
    # merge of the two shards in process order
    from defuse_tpu_torch.stats.readstats import (merge_read_stats,
                                                  read_stats_from_sam)
    oracle = merge_read_stats([
        read_stats_from_sam(synth_sam(N_PAIRS, SEED, 50)),
        read_stats_from_sam(synth_sam(N_PAIRS + 1000, SEED + 1, 75)),
    ])
    assert reps[0]["merged"] == reps[1]["merged"] == oracle.format()

    # the all_reduce over the mesh's data group: rank 0 contributes
    # 100..103, rank 1 200..203
    want = sum(range(100, 104)) + sum(range(200, 204))
    assert reps[0]["psum_total"] == reps[1]["psum_total"] == want


def test_gather_bit_exact_without_x64(tmp_path):
    """float64 sums past float32's precision and past 2**53, NaNs with
    payloads and uint64 words with the top bit set come back from every
    rank with all their bits; the raw-sums merge is ``stats_from_sums`` of
    the rank-order sums."""
    reps = reports(worker("gather", tmp_path), tmp_path)
    want = {
        "f64": [(F64 * (p + 1)).view(np.uint64).tolist() for p in range(2)],
        "nan": [NAN_BITS.tolist()] * 2,
        "u64": [(U64 + np.uint64(p)).tolist() for p in range(2)]}
    for rep in reps:
        assert rep["bits"] == want
        assert rep["sums"] == rep["sums_expect"]
    assert reps[0]["sums"] == reps[1]["sums"]


def test_barrier_names_must_agree(tmp_path):
    """Rank 0 at barrier ``a`` and rank 1 at ``b``: each rank raises,
    naming both barriers, instead of passing or hanging."""
    results = worker("mismatch", tmp_path, limit=120)
    for pid, (rc, out, err) in enumerate(results):
        assert rc == 7, (pid, out, err[-3000:])
        assert "BARRIER_MISMATCH" in out
        assert "'defuse:a'" in out and "'defuse:b'" in out


def test_one_process_without_a_launcher(monkeypatch):
    """No launcher in the environment: one process and no group; the
    gather returns this process's payload and a barrier passes.
    ``JAX_AUTO_DISTRIBUTED`` (TPU pod metadata) is refused, not ignored."""
    import torch.distributed as dist
    from defuse_tpu_torch.parallel import launch
    for name in LAUNCH_VARS:
        monkeypatch.delenv(name, raising=False)
    assert launch.init_distributed() == (0, 1)
    assert not dist.is_initialized()
    got = launch._allgather_bits(U64)
    assert got.shape == (1, len(U64)) and got.tobytes() == U64.tobytes()
    launch.DistContext(0, 1).barrier("cluster_inputs")
    assert str(launch.rank_device("cpu")) == "cpu"
    monkeypatch.setenv("JAX_AUTO_DISTRIBUTED", "1")
    with pytest.raises(NotImplementedError, match="not ported by decision"):
        launch.init_distributed()


def test_two_process_pipeline_parity(tmp_path, monkeypatch):
    """Two ranks align their fastq shard with global fragment ids, merge
    the read-stats sums and run the pipeline tail (rank 0
    ``run_pipeline(dist=ctx)``, rank 1 ``tail_partition_worker``): the
    results, ``clusters`` and ``splitreads.break`` are the bytes of the
    port's one-process run and of ``defuse_tpu``'s."""
    monkeypatch.setenv("DEFUSE_DEVICE_SCREEN", "force")  # rank 0 screens
    if not native.available():
        pytest.skip("native library required for the partitioned tail")
    from defuse_tpu_torch.io.fasta import write_fasta
    from defuse_tpu_torch.parallel.shard import split_fastq
    from synthdata import make_dataset, write_dataset

    ds = make_dataset(seed=31, n_fusion_frags=140, n_background_frags=100)
    paths = write_dataset(ds, tmp_path)
    gtf, genome_fa, repeats = references(ds, tmp_path)
    cdna_fa = tmp_path / "cdna.fa"
    write_fasta(str(cdna_fa), {f"{g.name}|{g.transcript}":
                               g.cdna(ds.genome) + "A" * 50
                               for g in ds.genes})
    port = package("defuse_tpu_torch")
    reads1, reads2, _ = port.index_paired_fastq(
        str(paths["fastq1"]), str(paths["fastq2"]), str(tmp_path / "reads"))
    per_shard = (len(reads1) + 1) // 2
    prefixes = split_fastq(str(tmp_path / "reads" / "reads.1.fastq"),
                           str(tmp_path / "reads" / "reads.2.fastq"),
                           str(tmp_path / "shards"), reads_per_job=per_shard)
    assert len(prefixes) == 2
    kw = {name: run_kwargs(package(name), ds, paths, tmp_path, gtf,
                           genome_fa, repeats)
          for name in ("defuse_tpu", "defuse_tpu_torch")}
    meta = {
        "n_shards": 2, "per_shard": per_shard, "shard_prefixes": prefixes,
        "cdna_fasta": str(cdna_fa), "genome_fasta": str(genome_fa),
        "gtf": str(gtf), "reference": str(paths["reference"]),
        "exons": str(paths["exons"]), "repeats": str(repeats),
        "fastq1": kw["defuse_tpu_torch"]["fastq1"],
        "fastq2": kw["defuse_tpu_torch"]["fastq2"],
        "expression": kw["defuse_tpu_torch"]["expression"]}
    (tmp_path / "meta.json").write_text(json.dumps(meta))

    # the one-process whole runs: the port's and defuse_tpu's
    outs_whole = {}
    for name in ("defuse_tpu", "defuse_tpu_torch"):
        pkg = package(name)
        whole = pkg.align_job(reads1=reads1, reads2=reads2,
                              outdir=str(tmp_path / f"whole_{name}"),
                              **indices(pkg, ds, gtf))
        outs_whole[name] = pkg.run_pipeline(
            output_dir=str(tmp_path / f"out_{name}"),
            library_name="dist-parity", spanning=whole["spanning"],
            improper=whole["improper"], concordant_sam=None,
            pair_table=whole["pair_table"], **kw[name])

    results = run_ranks([TESTS / "torch_dist_pipeline_worker.py", tmp_path],
                        limit=500)
    for pid, (rc, _out, err) in enumerate(results):
        assert rc == 0, (pid, err[-3000:])
    outs_dist = json.loads((tmp_path / "outs.json").read_text())
    assert outs_dist.pop("grouped_store") == [True]
    for name, out in outs_whole.items():
        for artifact in ("results", "classified", "filtered"):
            a = pathlib.Path(out[artifact]).read_bytes()
            assert a == pathlib.Path(outs_dist[artifact]).read_bytes(), \
                f"{artifact}: two ranks differ from {name}'s one process"
        for artifact in ("clusters", "splitreads.break"):
            a = (tmp_path / f"out_{name}" / artifact).read_bytes()
            assert a == (tmp_path / "out_dist" / artifact).read_bytes(), \
                f"{artifact}: two ranks differ from {name}'s one process"
    assert len(pathlib.Path(outs_dist["results"]).read_text()
               .splitlines()) > 1
    counters = json.loads((tmp_path / "out_dist" / "metrics.discover.json")
                          .read_text())["counters"]
    assert counters["em_impl"] == "native"
    assert counters["split_dp_impl"] == "torch"
    whole = (tmp_path / "out_defuse_tpu_torch" /
             "concordant.read.stats").read_text()
    for pid in range(2):
        assert (tmp_path / f"shard{pid}" / "stats.merged").read_text() \
            == whole


def test_rank0_failure_aborts_workers(tmp_path):
    """Rank 0 fails on a missing spanning file before the clustering
    rendezvous; the ``run_pipeline`` wrapper publishes an abort and drains
    both barriers; rank 1 wakes, sees the abort and exits loudly.  Both
    end well inside the limit."""
    if not native.available():
        pytest.skip("native library required for the partition worker")
    (tmp_path / "reads.1.fastq").write_text("")
    (tmp_path / "reads.2.fastq").write_text("")
    results = run_ranks([TESTS / "torch_dist_abort_worker.py", tmp_path],
                        limit=180)
    (rc0, out0, err0), (rc1, out1, err1) = results
    # rank 0 re-raised the original pipeline error after the rendezvous
    assert rc0 == 3, (out0, err0[-3000:])
    assert "RANK0_FAILED" in out0
    # rank 1 saw mode=abort and exited loudly instead of hanging
    assert rc1 == 5, (out1, err1[-3000:])
    assert "WORKER_ABORTED" in out1 and "abort" in out1
