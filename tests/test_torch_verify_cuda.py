"""The CUDA kernels of ``defuse_tpu_torch/csrc/verify.cu`` and
``csrc/issue_probe.cu`` against their plain PyTorch versions on the card,
exactly.  Skips where CUDA is absent.  Imports no ``jax``, so it also runs
on a machine without it:

    python -m pytest --noconftest -p no:cacheprovider \
        tests/test_torch_verify_cuda.py
"""

import numpy as np
import pytest
import torch

from defuse_tpu_torch.convert import verify_operands
from defuse_tpu_torch.ops import split_dp_census, verify_cuda, verify_roofline
from defuse_tpu_torch.ops.verify_batch import (DeviceVerifier,
                                               verify_packed3_ref)

from torch_cases import verify_case, verify_genome_case

# read lengths at both sides of every group width's edge: W + 1 = 8 | 9
# (8 and 16 lanes), 16 | 17 (16 and 32 lanes), 32 | 33 (32 lanes and the
# kernel that walks the row), and rows of more than two warps' words
GROUP_EDGES = {1: 8, 10: 8, 50: 8, 53: 8, 70: 8, 71: 16, 100: 16, 150: 16,
               151: 32, 310: 32, 311: 0, 700: 0}


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU")
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("case", [dict(seed=7), dict(seed=13, n_ref=200, L=10,
                                                     B=8, C=256),
                                  dict(seed=17, n_ref=999, L=101, B=16,
                                       C=70_000)])
def test_verify_kernel_matches_plain_on_card(cuda_device, case):
    codes, starts, reads, ridx, lens = verify_case(**case)
    ops = verify_operands(codes, starts, reads, ridx, lens, cuda_device)
    L = reads.shape[1]
    got = verify_cuda.verify_packed3(*ops, L)
    torch.testing.assert_close(got, verify_packed3_ref(*ops, L), rtol=0,
                               atol=0)
    assert got.device.type == "cuda" and got.dtype == torch.int32


@pytest.mark.cuda
@pytest.mark.parametrize("L", sorted(GROUP_EDGES))
@pytest.mark.parametrize("order", ["as_drawn", "sorted"])
def test_verify_kernel_every_group_width_on_card(cuda_device, L, order):
    """Every lane, the plane's last words, reads of length 0 and N runs
    (``verify_case``) at each group width; a candidate count that leaves
    the last warp partly filled; candidates as drawn and sorted by (read,
    position)."""
    assert verify_cuda.group_lanes(L) == GROUP_EDGES[L]
    codes, starts, reads, ridx, lens = verify_case(seed=L, L=L, C=4099)
    if order == "sorted":
        by = np.lexsort((starts, ridx))
        starts, ridx = starts[by], ridx[by]
    ops = verify_operands(codes, starts, reads, ridx, lens, cuda_device)
    want = verify_packed3_ref(*ops, L)
    assert int(want.max()) > 0 and int((want == 0).sum()) > 0
    torch.testing.assert_close(verify_cuda.verify_packed3(*ops, L), want,
                               rtol=0, atol=0)


@pytest.mark.cuda
@pytest.mark.parametrize("L", [50, 100, 200, 400])
@pytest.mark.parametrize("leg", ["gather", "compute"])
def test_verify_legs_match_plain_on_card(cuda_device, L, leg):
    codes, starts, reads, ridx, lens = verify_case(seed=L + 1, L=L, C=1500)
    ops = verify_operands(codes, starts, reads, ridx, lens, cuda_device)
    verify_cuda.reset_launches()
    got = verify_roofline.verify_leg(leg, *ops, L)
    cpu = tuple(t.cpu() for t in ops)
    torch.testing.assert_close(got.cpu(),
                               verify_roofline.verify_leg(leg, *cpu, L),
                               rtol=0, atol=0)
    assert verify_cuda.LAUNCHES == \
        dict.fromkeys(verify_cuda.LAUNCHES, 0) | {f"verify_{leg}": 1}


@pytest.mark.cuda
def test_verify_genome_case_on_card(cuda_device):
    """The device-made case at a small size: the source windows get their
    planted mismatches from the kernel, and the kernel equals the plain
    version on all candidates."""
    ops, is_source, planted = verify_genome_case(
        cuda_device, seed=1, n_bases=1_000_000, n_reads=4096, read_len=100)
    got = verify_cuda.verify_packed3(*ops, 100)
    torch.testing.assert_close(got, verify_packed3_ref(*ops, 100), rtol=0,
                               atol=0)
    assert torch.equal(got[is_source].long(),
                       planted[ops[4].long()[is_source]])


@pytest.mark.cuda
def test_verify_launches_are_counted_on_card(cuda_device, monkeypatch):
    monkeypatch.setenv("DEFUSE_DEVICE_VERIFY", "force")  # the kernel's route
    verify_cuda.reset_launches()
    codes, starts, reads, ridx, lens = verify_case(seed=3)
    ops = verify_operands(codes, starts, reads, ridx, lens, cuda_device)
    verify_cuda.verify_packed3(*ops, reads.shape[1])
    empty = verify_cuda.verify_packed3(ops[0], *(t[:0] for t in ops[1:3]),
                                       ops[3], ops[4][:0], ops[5],
                                       reads.shape[1])
    assert empty.shape == (0,)
    want = verify_packed3_ref(*ops, reads.shape[1]).cpu().numpy()
    verify_cuda.reset_launches()
    got = DeviceVerifier(cuda_device)(codes, starts, reads, ridx, lens)
    assert got.dtype == np.int64
    np.testing.assert_array_equal(got, want)
    assert verify_cuda.LAUNCHES["verify_packed3"] == 1


@pytest.mark.cuda
def test_verify_wrapper_rejects_what_the_kernel_does_not_take(cuda_device):
    codes, starts, reads, ridx, lens = verify_case(seed=5, C=128)
    ref3, w10, l10, reads3, ri, rl = verify_operands(codes, starts, reads,
                                                     ridx, lens, cuda_device)
    L = reads.shape[1]
    with pytest.raises(TypeError, match="ref3"):
        verify_cuda.verify_packed3(ref3.long(), w10, l10, reads3, ri, rl, L)
    with pytest.raises(TypeError, match="lane10"):
        verify_cuda.verify_packed3(ref3, w10, l10.int(), reads3, ri, rl, L)
    with pytest.raises(ValueError, match="contiguous"):
        verify_cuda.verify_packed3(ref3, w10[::2], l10[::2], reads3,
                                   ri[::2], rl, L)
    with pytest.raises(ValueError, match="words per row"):
        verify_cuda.verify_packed3(ref3, w10, l10, reads3, ri, rl, L + 10)
    with pytest.raises(ValueError, match="expected cuda"):
        verify_cuda.verify_packed3(ref3, w10.cpu(), l10, reads3, ri, rl, L)


@pytest.mark.cuda
@pytest.mark.parametrize("mix", split_dp_census.MIXES)
def test_probe_matches_plain_on_card(cuda_device, mix):
    seed = split_dp_census.probe_seed(cuda_device)
    split_dp_census.reset_launches()
    got = split_dp_census.issue_probe(seed, 64, mix)
    torch.testing.assert_close(
        got, split_dp_census.issue_probe_ref(seed, 64, mix), rtol=0, atol=0)
    assert split_dp_census.LAUNCHES == {"issue_probe": 1}
    with pytest.raises(ValueError, match="multiple"):
        split_dp_census.issue_probe(seed, 63, mix)
