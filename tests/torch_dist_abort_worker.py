"""Worker for the port's distributed-abort test: rank 0 runs
``run_pipeline`` against a missing spanning file so it fails before the
clustering rendezvous; rank 1 sits in ``tail_partition_worker``.  Without
the abort protocol rank 1 would block in the gloo ``cluster_inputs``
barrier until the group's limit; with it, rank 0's exception wrapper
publishes ``mode: abort`` and drains both barriers, and rank 1 exits
loudly.  Exit codes: 3 = rank 0 saw the original pipeline error, 5 = rank
1 saw the abort.  Usage: torch_dist_abort_worker.py <workdir>.
"""

import os
import pathlib
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))

TIMEOUT_S = 120


def main():
    work = pathlib.Path(sys.argv[1])

    from defuse_tpu_torch.config import Config
    from defuse_tpu_torch.parallel.launch import (DistContext,
                                                  init_distributed,
                                                  tail_partition_worker)

    pid, n_proc = init_distributed(timeout=TIMEOUT_S)
    ctx = DistContext(pid, n_proc)

    if pid == 0:
        from defuse_tpu_torch.pipeline.run import run_pipeline
        config = Config.defaults(
            reference_fasta=str(work / "missing.fa"),
            cdna_regions=str(work / "missing.regions"))
        try:
            run_pipeline(
                config=config, output_dir=str(work / "out"),
                library_name="abort-test",
                spanning=str(work / "missing.spanning"),
                improper=str(work / "missing.improper"),
                fastq1=str(work / "reads.1.fastq"),
                fastq2=str(work / "reads.2.fastq"),
                use_device=False, dist=ctx)
        except Exception as e:
            print(f"RANK0_FAILED {type(e).__name__}: {e}", flush=True)
            sys.exit(3)
        sys.exit(4)  # pipeline unexpectedly succeeded
    else:
        try:
            tail_partition_worker(ctx, work / "out")
        except RuntimeError as e:
            print(f"WORKER_ABORTED {e}", flush=True)
            sys.exit(5)
        sys.exit(6)  # worker unexpectedly completed


if __name__ == "__main__":
    main()
