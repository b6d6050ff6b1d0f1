"""The port's ``discover_fusions`` against ``defuse_tpu``'s: every
artifact byte-identical to the JAX package's host run and to its run with
the Pallas screen (interpreted on the CPU), and the port's screen keeps
exactly the candidate reads the JAX screen keeps on the same inputs.  Under
``DEFUSE_DEVICE_SCREEN=auto`` the screen runs where the routing decision at
the link sends it, with the same artifacts either way."""

import json

import numpy as np
import pytest

from defuse_tpu.cluster import native
from defuse_tpu.pipeline.discover import discover_fusions as jax_discover
from defuse_tpu_torch.ops import split_dp_cuda
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
    """The port on the CPU with its screen forced, the screen's operands
    and verdict recorded on their way through."""
    tmp, kw = dataset
    seen = {}
    mp = pytest.MonkeyPatch()
    mp.setenv("DEFUSE_DEVICE_SCREEN", "force")
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
    port_dir, seen = port_run
    metrics = json.loads((port_dir / "metrics.discover.json").read_text())
    counters = metrics["counters"]
    assert counters["split_dp_impl"] == "torch"
    route = counters["screen_route"]
    assert (route["mode"], route["choice"]) == ("force", "device")
    assert route["t_dev_s"] > 0 and route["t_host_s"] > 0
    assert counters["em_impl"] == "native"
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
    counters = json.loads((tmp / "port_off" / "metrics.discover.json")
                          .read_text())["counters"]
    assert "split_dp_impl" not in counters
    assert (counters["screen_route"]["mode"],
            counters["screen_route"]["choice"]) == ("off", "host")


@pytest.fixture(scope="module")
def jax_host(dataset):
    """``defuse_tpu``'s host run (no screen) of the dataset."""
    tmp, kw = dataset
    jax_discover(outdir=str(tmp / "jax_host"), use_device=False, **kw)
    return tmp / "jax_host"


@pytest.mark.parametrize("link,choice", [
    ({"DEFUSE_LINK_BW": "1", "DEFUSE_LINK_RTT": "100"}, "host"),
    ({"DEFUSE_LINK_BW": "1e12", "DEFUSE_LINK_RTT": "0"}, "device")])
def test_port_auto_screen_follows_the_link(dataset, jax_host, monkeypatch,
                                           link, choice, capsys):
    """``auto`` screens where ``routing.screen_decision`` at the overridden
    link puts the lower estimate: at 1 MB/s and 100 ms the link alone
    outweighs the native realign, at a free link the screen's rate beats
    four cores'.  The screen runs (its plain version here, no kernel
    launched) exactly when the recorded route says so, the printed line
    is the reference's, and the artifacts are ``defuse_tpu``'s bytes on
    either route."""
    tmp, kw = dataset
    for name, value in link.items():
        monkeypatch.setenv(name, value)
    monkeypatch.setenv("DEFUSE_DEVICE_SCREEN", "auto")
    monkeypatch.setenv("DEFUSE_STAGE_TIMING", "1")
    monkeypatch.setattr(port.native, "_default_threads", lambda: 4)
    screened = []
    screen = port.screen_candidates
    monkeypatch.setattr(port, "screen_candidates",
                        lambda *ops: screened.append(ops) or screen(*ops))
    split_dp_cuda.reset_launches()
    out = tmp / f"auto_{choice}"
    port.discover_fusions(outdir=str(out), device="cpu", **kw)
    counters = json.loads((out / "metrics.discover.json")
                          .read_text())["counters"]
    route = counters["screen_route"]
    assert (route["mode"], route["choice"]) == ("auto", choice)
    assert route["choice"] == ("device" if route["t_dev_s"] <
                               route["t_host_s"] else "host")
    assert len(screened) == (choice == "device")
    assert ("split_dp_impl" in counters) == (choice == "device")
    assert counters.get("screen_candidates", 0) == (
        len(screened[0][5]) if screened else 0)
    assert split_dp_cuda.LAUNCHES == {"split_dp_rowmax": 0,
                                      "split_dp_screen": 0,
                                      "split_dp_tie_columns": 0}
    assert f"[discover] screen: {choice} wins (est dev " in \
        capsys.readouterr().out
    for name in ARTIFACTS:
        assert (out / name).read_bytes() == (jax_host / name).read_bytes(), \
            name


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
    ({"em_mode": "batched"}, ValueError, "auto, native, oracle, device"),
    ({"em_mode": "device"}, None, None)])
def test_port_refuses_unported_modes(dataset, mode, error, item):
    """What the port still refuses writes nothing; ``em_mode="device"`` is
    refused no longer: on CPU tensors its ``clusters`` are the bytes of
    ``defuse_tpu``'s oracle EM, and without a card it raises at once."""
    import json
    import torch
    tmp, kw = dataset
    if error is not None:
        with pytest.raises(error, match=item):
            port.discover_fusions(outdir=str(tmp / "refused"), device="cpu",
                                  **mode, **kw)
        assert not (tmp / "refused").exists()
        return
    threads = torch.get_num_threads()
    torch.set_num_threads(1)  # small tensors: more threads only contend
    try:
        port.discover_fusions(outdir=str(tmp / "device_em"), device="cpu",
                              **mode, **kw)
    finally:
        torch.set_num_threads(threads)
    jax_discover(outdir=str(tmp / "jax_oracle"), use_device=False,
                 em_mode="oracle", **kw)
    for name in ARTIFACTS:
        assert (tmp / "device_em" / name).read_bytes() == \
            (tmp / "jax_oracle" / name).read_bytes(), name
    assert (tmp / "device_em" / "clusters").read_bytes()
    counters = json.loads((tmp / "device_em" / "metrics.discover.json")
                          .read_text())["counters"]
    assert counters["em_impl"] == "torch"
    assert counters["em_select"]["n_instances"] > 0
    assert counters["em_select"]["n_host_resolved"] == 0
    assert counters["em_run"]["rows"] >= counters["em_select"]["n_instances"]
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="is_available"):
            port.discover_fusions(outdir=str(tmp / "no_card"),
                                  use_device=False, **mode, **kw)
        assert not (tmp / "no_card").exists()


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


@pytest.mark.parametrize("n_parts", [1, 2])
def test_port_reads_sources_match(dataset, port_run, n_parts, monkeypatch):
    """``reads_sources`` (the distributed tail's per-rank read stores, each
    with its own ``.fqi`` and fragment ids from 0, grouped by global
    fragment-id base) gives the artifacts of the run without it, through
    one grouped store."""
    tmp, kw = dataset
    lines = [open(kw[f"fastq{end}"]).read().splitlines(True)
             for end in (1, 2)]
    n_frags = len(lines[0]) // 4
    bases = [i * -(-n_frags // n_parts) for i in range(n_parts)]
    sources = []
    for i, lo in enumerate(bases):
        part = tmp / f"reads_sources{n_parts}" / f"part{i}"
        part.mkdir(parents=True)
        hi = bases[i + 1] if i + 1 < n_parts else n_frags
        for end in (1, 2):
            with open(part / f"reads.{end}.fastq", "w") as fh:
                for frag in range(lo, hi):
                    fh.write(f"@{frag - lo}/{end}\n")
                    fh.writelines(lines[end - 1][4 * frag + 1:4 * frag + 4])
        fq = [str(part / f"reads.{end}.fastq") for end in (1, 2)]
        assert native.build_fqi(*fq, str(part / "reads.fqi"))
        sources.append((*fq, lo))
    grouped = []
    reads_group = port.native.reads_group
    monkeypatch.setattr(port.native, "reads_group", lambda *a: grouped.append(
        reads_group(*a)) or grouped[-1])
    out = tmp / f"reads_sources{n_parts}" / "out"
    port.discover_fusions(outdir=str(out), device="cpu",
                          reads_sources=sources, **kw)
    assert [g is not None for g in grouped] == [True]
    port_dir, _ = port_run
    for name in ARTIFACTS:
        assert (out / name).read_bytes() == (port_dir / name).read_bytes(), \
            name
