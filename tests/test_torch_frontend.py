"""The port's ``align_reads`` against ``defuse_tpu``'s: with
``DEFUSE_DEVICE_VERIFY=force`` every candidate of the Python seed path is
verified by the port's ``DeviceVerifier`` (here its plain version on the
CPU), and the artifacts are byte-identical to the JAX package's host run
(``use_device=False``: the native fused seed+verify).  The concordant SAM
is compared decompressed: its gzip members differ between the routes."""

import pathlib

import numpy as np
import pytest

from defuse_tpu.align.frontend import align_reads as jax_align_reads
from defuse_tpu.cluster import native
from defuse_tpu.io.sam import read_decompressed
from defuse_tpu_torch.align import frontend as port
from defuse_tpu_torch.ops import verify_batch

from synthdata import make_dataset, write_dataset, write_gtf
from torch_cases import frontend_config

ARTIFACTS = ("spanning", "improper", "concordant_sam", "pair_table")


@pytest.fixture(scope="module")
def dataset(tmp_path_factory):
    if not native.available():
        pytest.skip("native library not built")
    tmp = tmp_path_factory.mktemp("torch_frontend")
    ds = make_dataset(seed=29, n_fusion_frags=80, n_background_frags=80)
    paths = write_dataset(ds, tmp)
    config = frontend_config(ds, tmp / "refs")
    fq = (str(paths["fastq1"]), str(paths["fastq2"]))
    ref = jax_align_reads(config, str(tmp / "jax"), *fq, use_device=False)
    return tmp, config, fq, artifact_bytes(ref)


def artifact_bytes(res):
    out = {}
    for key in ARTIFACTS:
        assert res[key] is not None, key
        out[key] = read_decompressed(res[key]) if key != "pair_table" \
            else pathlib.Path(res[key]).read_bytes()
    return out


@pytest.fixture
def counted_verifier(monkeypatch):
    """Counts the candidates the port's verifier sees."""
    seen = {"calls": 0, "candidates": 0}
    call = verify_batch.DeviceVerifier.__call__

    def counting(self, codes, cand_pos, *rest):
        seen["calls"] += 1
        seen["candidates"] += len(cand_pos)
        return call(self, codes, cand_pos, *rest)

    monkeypatch.setattr(verify_batch.DeviceVerifier, "__call__", counting)
    return seen


@pytest.mark.parametrize("mode", ["force", "auto", "off"])
def test_port_artifacts_match_jax_package(dataset, counted_verifier,
                                          monkeypatch, mode):
    tmp, config, fq, want = dataset
    monkeypatch.setenv("DEFUSE_DEVICE_VERIFY", mode)
    res = port.align_reads(config, str(tmp / f"port_{mode}"), *fq,
                           device="cpu")
    got = artifact_bytes(res)
    for key in ARTIFACTS:
        assert got[key] == want[key], key
    assert len(got["improper"]) > 0 and len(got["spanning"]) > 0
    if mode == "force":
        assert counted_verifier["candidates"] > 500
    else:
        # auto keeps the native fused seed+verify while the library is
        # present; off never verifies on the device
        assert counted_verifier["calls"] == 0
    # the indices are saved beside their fastas: none is handed on
    assert res["target_indices"] == {}


def mapped_indices(under):
    """The ``*.seedidx.*.npy`` files under ``under`` that this process
    maps."""
    maps = pathlib.Path("/proc/self/maps")
    if not maps.exists():
        pytest.skip("no /proc/self/maps here")
    return {line.split()[-1] for line in maps.read_text().splitlines()
            if str(under) in line and ".seedidx." in line
            and line.endswith(".npy")}


@pytest.mark.parametrize("route", ["saved", "built", "short_read"])
def test_align_reads_hands_on_only_indices_built_in_memory(
        dataset, tmp_path, route):
    """``align_reads`` hands breakseq the genome and cDNA indices only where
    it built them in memory (no saved index, or the short-read k, whose
    seed length the saved one lacks); a saved index it maps is let go when
    it returns, so no page of it stays mapped under the stages after it."""
    from defuse_tpu_torch.align.seedindex import SeedIndex
    _tmp, _config, fq, _want = dataset
    ds = make_dataset(seed=29, n_fusion_frags=80, n_background_frags=80)
    refs = tmp_path / "refs"
    config = frontend_config(ds, refs, **(
        {"discord_read_trim": 40} if route == "short_read" else {}))
    fastas = [config.get_value(key) for key in ("genome_fasta",
                                                "cdna_fasta")]
    if route == "saved":
        for fasta in fastas:
            SeedIndex.load_or_build(fasta)
        held = SeedIndex.load(fastas[0] + ".seedidx")
        assert len(held.keys) and len(mapped_indices(refs)) >= 2
        del held
    assert mapped_indices(refs) == set()
    res = port.align_reads(config, str(tmp_path / "out"), *fq, device="cpu")
    assert len(res["improper"]) > 0
    handed = res["target_indices"]
    if route == "saved":
        assert handed == {}
    else:
        assert set(handed) == {"genome", "cdna"}
        for index in handed.values():
            assert not isinstance(index.keys, np.memmap)
            assert index.seed_len == (13 if route == "short_read" else 16)
    assert mapped_indices(refs) == set()


def test_port_without_device_matches(dataset, counted_verifier, monkeypatch):
    tmp, config, fq, want = dataset
    monkeypatch.setenv("DEFUSE_DEVICE_VERIFY", "force")
    res = port.align_reads(config, str(tmp / "port_host"), *fq,
                           use_device=False)
    assert artifact_bytes(res) == want
    assert counted_verifier["calls"] == 0


def test_port_frontend_needs_cuda_when_asked(dataset):
    import torch
    if torch.cuda.is_available():
        pytest.skip("CUDA is available here")
    tmp, config, fq, _want = dataset
    with pytest.raises(RuntimeError, match="is_available"):
        port.align_reads(config, str(tmp / "no_cuda"), *fq, device="cuda")


def test_align_job_returns_its_artifacts_and_stats(tmp_path, monkeypatch):
    """The port's ``align_job`` returns the paths of its four artifacts and
    the read stats, and no fragment sets, on the native path and on the
    Python oracle path (``force_python=True``)."""
    if not port.native.available():
        pytest.skip("native library not built")
    from defuse_tpu_torch.align.seedindex import SeedIndex
    from defuse_tpu_torch.annotate.gene_models import GeneModels
    ds = make_dataset(seed=47, n_fusion_frags=30, n_background_frags=30)
    paths = write_dataset(ds, tmp_path)
    gtf = tmp_path / "genes.gtf"
    write_gtf(ds, gtf)
    reads1, reads2, _ = port.index_paired_fastq(
        str(paths["fastq1"]), str(paths["fastq2"]), str(tmp_path / "reads"))
    cdna = {f"{g.name}|{g.transcript}": g.cdna(ds.genome) + "A" * 50
            for g in ds.genes}
    inputs = dict(reads1=reads1, reads2=reads2,
                  cdna_index=SeedIndex(cdna),
                  genome_index=SeedIndex(ds.genome), rrna_index=None,
                  gene_models=GeneModels(str(gtf)))
    native_runs = []
    align_native = port._align_job_native

    def spy(**kw):
        native_runs.append(align_native(**kw))
        return native_runs[-1]

    monkeypatch.setattr(port, "_align_job_native", spy)
    keys = {"spanning", "improper", "concordant_sam", "pair_table", "stats"}
    for force_python in (False, True):
        res = port.align_job(outdir=str(tmp_path / f"python_{force_python}"),
                             force_python=force_python, **inputs)
        assert set(res) == keys, force_python
        assert res["stats"].frag_count > 0, force_python
    assert len(native_runs) == 1 and native_runs[0] is not None


@pytest.fixture
def without_native(monkeypatch):
    """The port's frontend as it runs where the native library is absent:
    the Python ingest, seed indices and seed path, with the verifier
    engaged under ``auto``."""
    monkeypatch.setattr(port.native, "available", lambda: False)


def test_auto_verify_on_a_slow_link_takes_the_host_oracle(
        dataset, without_native, monkeypatch):
    """``auto`` with a link that makes the host win (1 MB/s, 100 ms) and no
    native library: every verifier call takes the numpy oracle, and the
    hits of every ``SeedIndex.verify`` call and the frontend's artifacts
    are those of the forced device route (its plain version here) and
    ``defuse_tpu``'s.  The raw counts agree at every in-bounds placement;
    past the reference's end the two routes read different padding, and
    ``SeedIndex.verify`` drops those placements (ROADMAP C4)."""
    from defuse_tpu_torch.align.seedindex import SeedIndex
    tmp, config, fq, want = dataset
    seen = {"verify": [], "hits": []}
    call, verify = verify_batch.DeviceVerifier.__call__, SeedIndex.verify

    def counting(self, *ops):
        counts = call(self, *ops)
        seen["verify"].append((ops, counts))
        return counts

    def hits(self, *args, **kw):
        out = verify(self, *args, **kw)
        seen["hits"].append(out)
        return out

    monkeypatch.setattr(verify_batch.DeviceVerifier, "__call__", counting)
    monkeypatch.setattr(SeedIndex, "verify", hits)
    runs = {}
    for mode, link in (("force", None), ("auto", ("1", "100"))):
        if link:
            monkeypatch.setenv("DEFUSE_LINK_BW", link[0])
            monkeypatch.setenv("DEFUSE_LINK_RTT", link[1])
        monkeypatch.setenv("DEFUSE_DEVICE_VERIFY", mode)
        seen["verify"], seen["hits"] = [], []
        res = port.align_reads(config, str(tmp / f"no_native_{mode}"), *fq,
                               device="cpu")
        runs[mode] = (artifact_bytes(res), dict(port.VERIFY_CALLS),
                      seen["verify"], seen["hits"])
    n = len(runs["force"][2])
    assert n > 0 and len(runs["auto"][2]) == n
    assert runs["force"][1] == {"device": n, "host": 0}
    assert runs["auto"][1] == {"device": 0, "host": n}
    assert runs["auto"][0] == runs["force"][0] == want
    for a, b in zip(runs["force"][3], runs["auto"][3]):
        assert all(np.array_equal(x, y) for x, y in zip(a, b))
    for (ops, forced), (_ops, host) in zip(runs["force"][2], runs["auto"][2]):
        codes, cand_pos, _reads, read_idx, read_lens = ops
        inside = (cand_pos >= 0) & \
            (cand_pos + read_lens[read_idx] <= len(codes))
        np.testing.assert_array_equal(forced[inside], host[inside])


def test_verifier_routes_each_call(monkeypatch):
    """``DeviceVerifier`` on CPU tensors: ``force`` and ``off`` as named,
    ``auto`` by the cost model, each call counted by route: the host at a
    slow link, the device at a free link against a host that verifies a
    candidate a second (at the card's rates the numpy oracle beats the
    device route at any link for 50 bp reads); the counts of both routes
    agree in bounds."""
    from defuse_tpu_torch.utils.synth import verify_case
    codes, starts, reads, ridx, lens = verify_case(7, L=50)
    verifier = verify_batch.DeviceVerifier("cpu")
    expect = {"device": 0, "host": 0}
    got = {}
    for mode, link, route in (("force", ("1", "100"), "device"),
                              ("off", ("1e12", "0"), "host"),
                              ("auto", ("1", "100"), "host"),
                              ("auto", ("1e12", "0"), "device")):
        monkeypatch.setenv("DEFUSE_DEVICE_VERIFY", mode)
        monkeypatch.setenv("DEFUSE_LINK_BW", link[0])
        monkeypatch.setenv("DEFUSE_LINK_RTT", link[1])
        if (mode, route) == ("auto", "device"):
            monkeypatch.setattr(verify_batch, "HOST_CANDIDATES_S", 1.0)
        got[route] = verifier(codes, starts, reads, ridx, lens)
        expect[route] += 1
        assert (verifier.calls_device, verifier.calls_host) == \
            (expect["device"], expect["host"]), (mode, link)
    inside = (starts >= 0) & (starts + lens[ridx] <= len(codes))
    np.testing.assert_array_equal(got["device"][inside], got["host"][inside])
    assert got["host"][inside].max() > 0
