"""The port's ``discover_fusions`` against ``defuse_tpu``'s: every
artifact byte-identical to the JAX package's host run and to its run with
the Pallas screen (interpreted on the CPU), and the port's screen keeps
exactly the candidate reads the JAX screen keeps on the same inputs."""

import numpy as np
import pytest

from defuse_tpu.cluster import native
from defuse_tpu.pipeline.discover import discover_fusions as jax_discover
from defuse_tpu_torch.pipeline import discover as port

from synthdata import make_dataset, write_dataset
from test_split_chain_parity import (MEAN, STD, PREC, MINCL, MINREAD,
                                     MAXREAD)

ARTIFACTS = ("clusters", "clusters.sc", "clusters.sc.regions",
             "splitreads.alignments", "splitreads.seq", "splitreads.break",
             "splitreads.predalign")


@pytest.fixture(scope="module")
def dataset(tmp_path_factory):
    if not native.available():
        pytest.skip("native library not built")
    tmp = tmp_path_factory.mktemp("torch_discover")
    ds = make_dataset(seed=31, fusion_pair=("TA", "TD"), break_a=2400,
                      break_b=1000)
    paths = write_dataset(ds, tmp)
    kw = dict(spanning=str(paths["spanning"]),
              improper=str(paths["improper"]),
              fastq1=str(paths["fastq1"]), fastq2=str(paths["fastq2"]),
              reference=str(paths["reference"]), exons=str(paths["exons"]),
              fragment_mean=MEAN, fragment_stddev=STD, precision=PREC,
              min_cluster_size=MINCL, min_read_length=MINREAD,
              max_read_length=MAXREAD)
    return tmp, kw


@pytest.fixture(scope="module")
def port_run(dataset):
    """The port on the CPU, with the screen's operands and verdict
    recorded on their way through."""
    tmp, kw = dataset
    seen = {}
    mp = pytest.MonkeyPatch()
    screen_operands, screen_candidates = port.screen_operands, \
        port.screen_candidates

    def record_operands(*args):
        seen["operands"] = args
        return screen_operands(*args)

    def record_scores(*ops):
        scores = screen_candidates(*ops)
        seen["scores"] = scores.numpy().copy()
        return scores

    mp.setattr(port, "screen_operands", record_operands)
    mp.setattr(port, "screen_candidates", record_scores)
    try:
        port.discover_fusions(outdir=str(tmp / "port"), device="cpu", **kw)
    finally:
        mp.undo()
    return tmp / "port", seen


@pytest.mark.parametrize("screen", ["host", "pallas"])
def test_port_artifacts_match_jax_package(dataset, port_run, screen,
                                          monkeypatch):
    tmp, kw = dataset
    if screen == "pallas":
        monkeypatch.setenv("DEFUSE_DEVICE_SCREEN", "force")
    jax_discover(outdir=str(tmp / screen), use_device=screen == "pallas",
                 **kw)
    port_dir, _ = port_run
    for name in ARTIFACTS:
        assert (port_dir / name).read_bytes() == \
            (tmp / screen / name).read_bytes(), name
    assert (port_dir / "splitreads.seq").read_bytes(), "no fusion called"


def test_port_survivors_match_jax_screen(port_run):
    from defuse_tpu.ops.split_dp_pallas import screen_candidates_pallas
    port_dir, seen = port_run
    (u1p, u1l, u2rp, u2l, fidx, reads, read_lens, mins,
     _device) = seen["operands"]
    assert len(reads) == 189
    want = np.asarray(screen_candidates_pallas(
        u1p, u1l, u2rp, u2l, fidx, reads, read_lens, mins))
    np.testing.assert_array_equal(seen["scores"] > 0, want > 0)
    np.testing.assert_array_equal(seen["scores"], want)
    assert 0 < (want > 0).sum() < len(want)


def test_port_metrics_name_the_screen(port_run):
    import json
    port_dir, seen = port_run
    metrics = json.loads((port_dir / "metrics.discover.json").read_text())
    counters = metrics["counters"]
    assert counters["split_dp_impl"] == "torch"
    assert counters["screen_candidates"] == len(seen["scores"])
    assert counters["screen_survivors"] == int((seen["scores"] > 0).sum())
    stages = [s["stage"] for s in metrics["stages"]]
    assert "discover:screen:device" in stages
    assert stages[-1] == "discover:evaluate"


def test_port_screen_off_matches(dataset, port_run, monkeypatch):
    tmp, kw = dataset
    monkeypatch.setenv("DEFUSE_DEVICE_SCREEN", "off")
    port.discover_fusions(outdir=str(tmp / "port_off"), device="cpu", **kw)
    port_dir, _ = port_run
    for name in ARTIFACTS:
        assert (port_dir / name).read_bytes() == \
            (tmp / "port_off" / name).read_bytes(), name
    import json
    counters = json.loads((tmp / "port_off" / "metrics.discover.json")
                          .read_text())["counters"]
    assert "split_dp_impl" not in counters


def test_port_needs_cuda_when_asked(dataset):
    import torch
    if torch.cuda.is_available():
        pytest.skip("CUDA is available here")
    tmp, kw = dataset
    with pytest.raises(RuntimeError, match="is_available"):
        port.discover_fusions(outdir=str(tmp / "no_cuda"), device="cuda",
                              **kw)


def test_port_with_gene_models_matches_jax_package(dataset):
    """The run-pipeline form: mitochondrial segregation and the
    post-setcover filters from the gene models."""
    from defuse_tpu.annotate.gene_models import GeneModels
    from synthdata import write_gtf
    tmp, kw = dataset
    ds = make_dataset(seed=31, fusion_pair=("TA", "TD"), break_a=2400,
                      break_b=1000)
    write_gtf(ds, tmp / "genes.gtf")
    gm = GeneModels(str(tmp / "genes.gtf"))
    jax_discover(outdir=str(tmp / "gm_host"), use_device=False,
                 gene_models=gm, **kw)
    port.discover_fusions(outdir=str(tmp / "gm_port"), device="cpu",
                          gene_models=gm, **kw)
    for name in ARTIFACTS:
        assert (tmp / "gm_port" / name).read_bytes() == \
            (tmp / "gm_host" / name).read_bytes(), name


@pytest.mark.parametrize("mode,error,item", [
    ({"em_mode": "device"}, ValueError, "B6/A11"),
    ({"reads_sources": [("a", "b", 0)]}, NotImplementedError, "B7/A12")])
def test_port_refuses_unported_modes(dataset, mode, error, item):
    tmp, kw = dataset
    with pytest.raises(error, match=item):
        port.discover_fusions(outdir=str(tmp / "refused"), device="cpu",
                              **mode, **kw)
    assert not (tmp / "refused").exists()


def test_port_oracle_em_matches_native_em(dataset, port_run):
    """``em_mode="oracle"`` (the Python EM, exact) with the native realign:
    the artifacts of the native EM."""
    tmp, kw = dataset
    port.discover_fusions(outdir=str(tmp / "oracle"), device="cpu",
                          em_mode="oracle", **kw)
    port_dir, _ = port_run
    for name in ARTIFACTS:
        assert (port_dir / name).read_bytes() == \
            (tmp / "oracle" / name).read_bytes(), name
