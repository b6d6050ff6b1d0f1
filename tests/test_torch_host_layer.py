"""The port's own host layer (``defuse_tpu_torch``) against the modules of
``defuse_tpu`` it was copied from: the source is the reference's after the
package rename, except for the modules of ``DIVERGED``, each with its
reason; and the port's dataset maker writes the files of ``bench.py``'s."""

import ast
import difflib
import filecmp
import pathlib
import re
import sys

import pytest

REPO = pathlib.Path(__file__).resolve().parent.parent
REFERENCE, PORT = REPO / "defuse_tpu", REPO / "defuse_tpu_torch"

COPIED = (
    "core/types.py", "stats/normal.py", "stats/readstats.py",
    "utils/checks.py", "config.py", "utils/profiling.py", "io/fasta.py",
    "io/readindex.py", "io/sam.py", "core/exons.py",
    "annotate/gene_models.py", "cluster/native.py", "cluster/kmeans.py",
    "cluster/matepair_em.py", "cluster/setcover.py", "pipeline/regions.py",
    "align/split_dp.py", "align/sw.py", "align/tasks.py",
    "align/batch_realign.py", "filters/cluster_filters.py",
    "align/seedindex.py", "parallel/shard.py", "align/frontend.py",
    "stats/crand.py", "stats/calccov.py", "stats/pvalues.py",
    "pipeline/runner.py", "filters/estislands.py",
    "annotate/mapping_stats.py", "annotate/extra.py",
    "annotate/features.py", "annotate/collate.py", "annotate/adaboost.py",
    "align/breakseq.py", "align/matealign.py", "align/denovo.py",
    "pipeline/denovo_arbitration.py", "pipeline/denovo_stage.py",
    "cluster/hierarchical.py", "cluster/discordant.py", "pipeline/run.py",
    "io/bam.py", "cli/get_reads.py", "cli/exporters.py",
    "cli/expression_plot.py", "pipeline/create_ref.py",
    "pipeline/acquire.py", "pipeline/cohort.py", "cli/main.py",
    "cli/__init__.py", "__main__.py", "cluster/matepair_em_batch.py",
    "parallel/launch.py", "ops/verify_batch.py", "pipeline/discover.py",
    "core/devices.py")

# module: (why it differs, names whose source must still be the reference's)
DIVERGED = {
    "align/frontend.py": (
        "align_reads wires the port's DeviceVerifier (require_cuda, no "
        "device probe; the verifier's cost model routes each call) where "
        "the reference imports its JAX verifier, and records the calls of "
        "each route in VERIFY_CALLS; the rest is the reference's text",
        ("SingleAlignment", "index_paired_fastq", "_align_all",
         "_align_all_native", "align_job")),
    "align/batch_realign.py": (
        "the screen goes to ops/split_dp_cuda.screen_candidates, "
        "realign_candidates and _device_tie_columns take the device their "
        "torch operands go to (convert.tie_operands), and the tie columns "
        "go to ops/split_dp_cuda.dp_tie_columns_cuda: the hand kernel on a "
        "CUDA device, the plain version on the CPU",
        ("Candidate", "collect_candidates", "_np_rows",
         "collect_candidates_native", "_native_rows",
         "realign_candidates_native", "_columns", "_pad_len")),
    "cluster/discordant.py": (
        "cluster_alignments takes the device its batched EM runs on "
        "(em_mode='device'), checks it before anything else and hands it "
        "to the port's run_batch",
        ("ClusterRow", "BinPairTask", "collect_bin_pair_tasks",
         "emit_cluster_rows", "strand_remap_vec", "write_clusters")),
    "pipeline/run.py": (
        "_run_pipeline takes device and checks the card up front where the "
        "reference starts its probe; it binds the port's discover_fusions",
        ("run_pipeline", "_notify_completion", "_read_stats_file",
         "_span_stats", "_span_stats_from_breaks",
         "materialize_cov_samples")),
    "parallel/launch.py": (
        "init_distributed joins a gloo process group from torchrun's "
        "variables or the reference launcher's (and refuses "
        "JAX_AUTO_DISTRIBUTED); rank_device is the port's; "
        "DistContext.barrier gathers the barrier names and raises on a "
        "mismatch; _allgather_bits gathers int32 views with "
        "torch.distributed; global_mesh is a DeviceMesh over the ranks",
        ("abort_cluster_partition", "cluster_partition_worker",
         "tail_partition_worker", "merge_artifacts", "merge_stats_files",
         "allgather_read_stats", "allgather_read_stats_sums",
         "MAX_READLEN_GATHER")),
    "pipeline/cohort.py": (
        "run_cohort takes device, checks the card before any library "
        "starts and hands --device to each library's run; _rank_nprocs "
        "reads torchrun's RANK/WORLD_SIZE ahead of the reference "
        "launcher's JAX_PROCESS_ID/JAX_NUM_PROCESSES, which it keeps",
        ("Library", "read_manifest", "merge_cohort")),
    "pipeline/create_ref.py": (
        "the first line of the module docstring is reworded; the code is "
        "the reference's text",
        ("create_reference",)),
    "cli/main.py": (
        "run and cohort take --device {cuda,cpu} and check the card at "
        "once; the other six verbs are the reference's text",
        ("_find_or_materialize_pair_sam",)),
    "cluster/matepair_em_batch.py": (
        "on a CUDA device em_run is the hand-written kernel csrc/em.cu "
        "(ops/em_cuda.py: every row to its end in one launch a slab "
        "segment), and the loop of PyTorch ops (_build_em_run_plain, "
        "_exponents to _m_step) is its plain version, which CPU tensors "
        "run; the rest of the device program (the slab step, "
        "_run_bucketed, run_batch) is PyTorch on the tensors' device, "
        "without the one-hot masks, the compile-shape padding and the "
        "memory constants of the JAX program; prepare_batch and "
        "_resolve_exact lose the timings of "
        "the reference's hardware from their comments and fall back to "
        "Python only on AttributeError (a library built before the batch "
        "entry points), where the reference swallows every exception; "
        "the rest of the host half is the reference's text",
        ("EMBatch", "_seed", "_select_kkz", "_shape_buckets", "_bucket_of",
         "select_memberships", "PROB_LOG_MARGIN", "BIC_MARGIN",
         "LAST_SELECT_STATS", "MAX_ITERS", "BIG", "K_BUCKETS",
         "N_BUCKETS_BASE")),
    "ops/verify_batch.py": (
        "the device program is plain PyTorch (verify_packed3_ref) beside "
        "the port's CUDA kernel; verify_cost_model is back with the "
        "reference's terms and the card's rates (DEVICE_LANES_S, "
        "HOST_CANDIDATES_S), defaults to the card's link_profile, and "
        "DeviceVerifier routes each call by it and counts the calls of "
        "each route; the host route is the reference's numpy oracle",
        ("BASES_PER_WORD",)),
    "pipeline/discover.py": (
        "the port's own version of the same stages: the screen's decision "
        "is the reference's cost model (routing.screen_decision at the "
        "card's link, recorded as screen_route), without the wait for a "
        "device probe and the budget that bounds it: the port has no "
        "probe; the device stages go to the port's kernels",
        ()),
    "core/devices.py": (
        "require_cuda and gpu_identity in place of the TPU probe "
        "subprocess and the compilation cache; link_profile returns the "
        "card's link as constants measured on it, with the reference's "
        "DEFUSE_LINK_BW/DEFUSE_LINK_RTT override, and probes nothing",
        ()),
    "utils/profiling.py": (
        "device_trace runs torch.profiler instead of jax.profiler, and "
        "cuda_time_ms is the port's; Tracer is the reference's text",
        ("Tracer",)),
}


def renamed(text: str) -> str:
    return re.sub(r"\bdefuse_tpu\b", "defuse_tpu_torch", text)


def definition(text: str, name: str) -> str:
    """Source of the top-level ``def``/``class`` ``name``, decorators
    included, or of the top-level assignment to ``name``."""
    for node in ast.parse(text).body:
        if isinstance(node, (ast.FunctionDef, ast.ClassDef)) \
                and node.name == name:
            start = min([node.lineno] +
                        [d.lineno for d in node.decorator_list])
            return "\n".join(text.splitlines()[start - 1:node.end_lineno])
        targets = node.targets if isinstance(node, ast.Assign) else \
            [node.target] if isinstance(node, ast.AnnAssign) else []
        if any(isinstance(t, ast.Name) and t.id == name for t in targets):
            return ast.get_source_segment(text, node)
    raise KeyError(name)


@pytest.mark.parametrize("module", COPIED)
def test_host_module_is_the_reference_source(module):
    ref = renamed((REFERENCE / module).read_text())
    port = (PORT / module).read_text()
    if module not in DIVERGED:
        diff = "".join(difflib.unified_diff(
            ref.splitlines(True), port.splitlines(True), "reference",
            "port", n=0))
        assert port == ref, diff[:2000]
        return
    why, same = DIVERGED[module]
    assert why and port != ref, f"{module} no longer differs: drop its entry"
    for name in same:
        assert definition(port, name) == definition(ref, name), name


def test_diverged_names_only_copied_modules():
    assert set(DIVERGED) <= set(COPIED)
    assert len(COPIED) == len(set(COPIED)) == 57


def test_tie_column_enumeration_names_its_roadmap_item():
    """The enumeration is ported (ROADMAP B4/A7, struck): it answers on CPU
    tensors, and a card that is absent raises instead of moving the call."""
    import torch
    from defuse_tpu_torch.align import batch_realign
    args = (["ACGTACGTAC"], ["ACGTACGTAC"], [[10]], [7], 128, 1, [10])
    assert batch_realign._device_tie_columns(*args, device="cpu") == \
        {(7, 10): [10]}
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="is_available"):
            batch_realign._device_tie_columns(*args)


def test_cli_main_differs_only_in_the_device_flag():
    """``cli/main.py`` against the reference's text: every changed line
    belongs to the ``--device`` flag, its check or its hand-down."""
    ref = renamed((REFERENCE / "cli/main.py").read_text()).splitlines()
    port = (PORT / "cli/main.py").read_text().splitlines()
    changed = [line[1:] for line in difflib.unified_diff(
        ref, port, n=0, lineterm="") if line[:1] in "+-"
        and line[:3] not in ("+++", "---")]
    words = ("device", "cuda", "cpu", "card", "kernels", "plain PyTorch",
             "host")
    stray = [line for line in changed if line.strip()
             and not any(w in line for w in words)]
    assert not stray, stray
    assert 0 < len(changed) < 40


def test_synth_dataset_is_the_bench_dataset(tmp_path):
    """``utils.synth.build_dataset`` writes what ``bench.build_dataset``
    writes, file for file, and returns the same reads."""
    sys.path.insert(0, str(REPO))
    try:
        import bench
    finally:
        sys.path.remove(str(REPO))
    from defuse_tpu_torch.utils import synth
    ds_a, paths_a, n_a = bench.build_dataset(tmp_path / "bench")
    ds_b, paths_b, n_b = synth.build_dataset(tmp_path / "port")
    assert n_a == n_b == 92_800
    assert sorted(paths_a) == sorted(paths_b)
    for key in paths_a:
        rel_a = pathlib.Path(paths_a[key]).relative_to(tmp_path / "bench")
        rel_b = pathlib.Path(paths_b[key]).relative_to(tmp_path / "port")
        assert rel_a == rel_b, key
        assert filecmp.cmp(paths_a[key], paths_b[key], shallow=False), key
    assert ds_a.reads1 == ds_b.reads1 and ds_a.sam_rows == ds_b.sam_rows
    for name in ("MEAN", "STD", "PREC", "MINCL", "MINREAD", "MAXREAD"):
        assert getattr(synth, name) == getattr(bench, name)


@pytest.mark.parametrize("name", ["Gene", "SynthDataset", "random_seq",
                                  "make_dataset", "write_dataset",
                                  "write_gtf", "write_repeats"])
def test_synth_helpers_are_the_test_helpers_source(name):
    from defuse_tpu_torch.utils import synth
    import synthdata
    port = definition(pathlib.Path(synth.__file__).read_text(), name)
    ref = definition(pathlib.Path(synthdata.__file__).read_text(), name)
    if name == "random_seq":  # the port imports numpy at the top
        ref = ref.replace("    import numpy as np\n", "")
    assert port == ref


def test_prepare_batch_differs_only_in_comments_and_the_catch():
    """``prepare_batch`` and ``_resolve_exact`` against the reference's
    text: docstring and comments apart, the code is the same but for the
    exception each catches."""
    def code(path, name):
        func = ast.parse(definition(path.read_text(), name)).body[0]
        func.body = func.body[1:]  # the docstring
        return ast.dump(func)

    module = "cluster/matepair_em_batch.py"
    for name in ("prepare_batch", "_resolve_exact"):
        ref, port = code(REFERENCE / module, name), code(PORT / module, name)
        assert ref != port
        assert ref == port.replace("id='AttributeError'", "id='Exception'")
