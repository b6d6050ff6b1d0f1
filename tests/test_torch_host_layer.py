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
    "cli/__init__.py", "__main__.py")

# module: (why it differs, names whose source must still be the reference's)
DIVERGED = {
    "align/frontend.py": (
        "align_reads wires the port's DeviceVerifier (require_cuda, no "
        "device probe, no cost model) where the reference imports its JAX "
        "verifier; the rest is the reference's text",
        ("SingleAlignment", "index_paired_fastq", "_align_all",
         "_align_all_native", "align_job")),
    "align/batch_realign.py": (
        "the screen goes to ops/split_dp_cuda.screen_candidates, and "
        "realign_candidates and _device_tie_columns take the device their "
        "torch operands go to (convert.tie_operands)",
        ("Candidate", "collect_candidates", "_np_rows",
         "collect_candidates_native", "_native_rows",
         "realign_candidates_native", "_columns", "_pad_len")),
    "cluster/discordant.py": (
        "cluster_alignments(em_mode='device') raises: the batched device "
        "EM is not ported (ROADMAP B6/A11)",
        ("ClusterRow", "BinPairTask", "collect_bin_pair_tasks",
         "emit_cluster_rows", "strand_remap_vec", "write_clusters")),
    "pipeline/run.py": (
        "run_pipeline takes device, checks the card up front where the "
        "reference starts its probe, and refuses more than one process "
        "(ROADMAP B7/A12); it binds the port's discover_fusions",
        ("_notify_completion", "_read_stats_file", "_span_stats",
         "_span_stats_from_breaks", "materialize_cov_samples")),
    "pipeline/cohort.py": (
        "run_cohort takes device, checks the card before any library "
        "starts and hands --device to each library's run",
        ("Library", "read_manifest", "_rank_nprocs", "merge_cohort")),
    "pipeline/create_ref.py": (
        "the first line of the module docstring is reworded; the code is "
        "the reference's text",
        ("create_reference",)),
    "cli/main.py": (
        "run and cohort take --device {cuda,cpu} and check the card at "
        "once; the other six verbs are the reference's text",
        ("_find_or_materialize_pair_sam",)),
    "utils/profiling.py": (
        "device_trace runs torch.profiler instead of jax.profiler, and "
        "cuda_time_ms is the port's; Tracer is the reference's text",
        ("Tracer",)),
}


def renamed(text: str) -> str:
    return re.sub(r"\bdefuse_tpu\b", "defuse_tpu_torch", text)


def definition(text: str, name: str) -> str:
    """Source of the top-level ``def``/``class`` ``name``, decorators
    included."""
    for node in ast.parse(text).body:
        if isinstance(node, (ast.FunctionDef, ast.ClassDef)) \
                and node.name == name:
            start = min([node.lineno] +
                        [d.lineno for d in node.decorator_list])
            return "\n".join(text.splitlines()[start - 1:node.end_lineno])
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
    assert len(COPIED) == len(set(COPIED)) == 52


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
                                  "write_dataset", "write_gtf",
                                  "write_repeats"])
def test_synth_helpers_are_the_test_helpers_source(name):
    from defuse_tpu_torch.utils import synth
    import synthdata
    port = definition(pathlib.Path(synth.__file__).read_text(), name)
    ref = definition(pathlib.Path(synthdata.__file__).read_text(), name)
    if name == "random_seq":  # the port imports numpy at the top
        ref = ref.replace("    import numpy as np\n", "")
    assert port == ref
