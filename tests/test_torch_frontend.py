"""The port's ``align_reads`` against ``defuse_tpu``'s: with
``DEFUSE_DEVICE_VERIFY=force`` every candidate of the Python seed path is
verified by the port's ``DeviceVerifier`` (here its plain version on the
CPU), and the artifacts are byte-identical to the JAX package's host run
(``use_device=False``: the native fused seed+verify).  The concordant SAM
is compared decompressed: its gzip members differ between the routes."""

import pathlib

import pytest

from defuse_tpu.align.frontend import align_reads as jax_align_reads
from defuse_tpu.cluster import native
from defuse_tpu.io.sam import read_decompressed
from defuse_tpu_torch.align import frontend as port
from defuse_tpu_torch.ops import verify_batch

from synthdata import make_dataset, write_dataset
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
    assert set(res["target_indices"]) == {"genome", "cdna"}


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
