"""Worker for tests/test_torch_distributed.py: one rank of a real
two-process ``torch.distributed`` run of the port on the CPU (gloo).

Modes (``torch_dist_worker.py <mode> <out_dir> [args]``):

* ``launch <n_pairs> <seed>``: ``init_distributed`` from the environment,
  ``global_mesh`` (shape, names, an ``all_reduce`` over its ``data``
  group) and the cross-process read-stats merge (``allgather_read_stats``);
* ``gather``: ``_allgather_bits`` of float64 and uint64 payloads whose
  bits a narrowing gather would lose, and ``allgather_read_stats_sums``;
* ``mismatch``: rank 0 enters barrier ``a``, the others barrier ``b``;
  each rank must raise, naming both (exit code 7).

Writes ``report.<rank>.json`` into ``out_dir`` for the test to assert on.
Imports no ``jax``.
"""

import json
import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))

import numpy as np  # noqa: E402
import torch  # noqa: E402

TIMEOUT_S = 120  # the gloo group's limit on every collective


def synth_sam(n_pairs, seed, readlen):
    """Deterministic proper-pair SAM shard (read_stats.pl input shape)."""
    rng = np.random.default_rng(seed)
    lines = []
    for i in range(n_pairs):
        isize = int(rng.integers(150, 350))
        seq = "A" * readlen
        qual = "I" * readlen
        lines.append(f"{seed}_{i}/1\t99\tchr1\t100\t255\t{readlen}M\t=\t"
                     f"{100 + isize - readlen}\t{isize}\t{seq}\t{qual}")
        lines.append(f"{seed}_{i}/2\t147\tchr1\t{100 + isize - readlen}\t"
                     f"255\t{readlen}M\t=\t100\t{-isize}\t{seq}\t{qual}")
    return lines


# payloads whose bits a float32 or uint32 gather would lose: sums past
# 2**53's float32 precision, NaNs with payloads, uint64 with the top bit set
F64 = np.array([45102084.0, 8997644846.0, 1813057613648.0, 2.0 ** 53 + 2,
                -0.0, np.inf], dtype=np.float64)
NAN_BITS = np.array([0x7FF8000000000001, 0xFFF0DEADBEEF0001],
                    dtype=np.uint64)
U64 = np.array([1 << 63, (1 << 64) - 1, 1 << 50, 3], dtype=np.uint64)


def launch(pid, n_proc, n_pairs, seed):
    from defuse_tpu_torch.parallel.launch import (allgather_read_stats,
                                                  global_mesh)
    from defuse_tpu_torch.stats.readstats import read_stats_from_sam
    import torch.distributed as dist

    # per-process shard: different sizes and read lengths per process
    local = read_stats_from_sam(
        synth_sam(n_pairs + pid * 1000, seed + pid, 50 + 25 * pid))
    merged = allgather_read_stats(local)
    mesh = global_mesh(inst_size=1)
    counts = torch.arange(4, dtype=torch.int64) + 100 * (pid + 1)
    total = counts.sum().reshape(1)
    dist.all_reduce(total, group=mesh.get_group("data"))
    return {"merged": merged.format(), "psum_total": int(total),
            "mesh_shape": list(mesh.shape),
            "mesh_names": list(mesh.mesh_dim_names),
            "backend": dist.get_backend()}


def gather(pid, n_proc):
    from defuse_tpu_torch.parallel.launch import (_allgather_bits,
                                                  allgather_read_stats_sums)
    from defuse_tpu_torch.stats.readstats import stats_from_sums
    f64 = F64 * (pid + 1)
    nan = NAN_BITS.view(np.float64)
    u64 = U64 + np.uint64(pid)
    got = {name: _allgather_bits(a) for name, a in
           (("f64", f64), ("nan", nan), ("u64", u64))}
    for name, a in (("f64", f64), ("nan", nan), ("u64", u64)):
        g = got[name]
        assert g.dtype == a.dtype and g.shape == (n_proc, len(a)), name
        assert g[pid].tobytes() == a.tobytes(), name
    n, s, ss = 45102084.0, 8997644846.0, 1813057613648.0
    merged = allgather_read_stats_sums(n, s, ss, [50, 100 + pid])
    expect = stats_from_sums(n * n_proc, s * n_proc, ss * n_proc,
                             [50] + [100 + p for p in range(n_proc)])
    return {"bits": {k: v.view(np.uint64).tolist() for k, v in got.items()},
            "sums": merged.format(), "sums_expect": expect.format()}


def mismatch(pid, n_proc):
    from defuse_tpu_torch.parallel.launch import DistContext
    try:
        DistContext(pid, n_proc).barrier("a" if pid == 0 else "b")
    except RuntimeError as e:
        print(f"BARRIER_MISMATCH {e}", flush=True)
        sys.exit(7)
    return {"passed": True}


def main():
    mode, out_dir = sys.argv[1], sys.argv[2]
    from defuse_tpu_torch.parallel.launch import init_distributed
    pid, n_proc = init_distributed(timeout=TIMEOUT_S)
    if mode == "launch":
        report = launch(pid, n_proc, int(sys.argv[3]), int(sys.argv[4]))
    else:
        report = {"gather": gather, "mismatch": mismatch}[mode](pid, n_proc)
    report.update(pid=pid, n_proc=n_proc)
    with open(os.path.join(out_dir, f"report.{pid}.json"), "w") as fh:
        json.dump(report, fh)
    assert "jax" not in sys.modules and "defuse_tpu" not in sys.modules
    print(f"worker {pid}: ok", flush=True)


if __name__ == "__main__":
    main()
