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
from defuse_tpu_torch.ops import split_dp_census, verify_cuda
from defuse_tpu_torch.ops.verify_batch import (DeviceVerifier,
                                               verify_packed3_ref)

from torch_cases import verify_case


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
def test_verify_launches_are_counted_on_card(cuda_device):
    verify_cuda.reset_launches()
    codes, starts, reads, ridx, lens = verify_case(seed=3)
    ops = verify_operands(codes, starts, reads, ridx, lens, cuda_device)
    verify_cuda.verify_packed3(*ops, reads.shape[1])
    empty = verify_cuda.verify_packed3(ops[0], *(t[:0] for t in ops[1:3]),
                                       ops[3], ops[4][:0], ops[5],
                                       reads.shape[1])
    assert empty.shape == (0,)
    verifier = DeviceVerifier(cuda_device, batch=1000)
    got = verifier(codes, starts, reads, ridx, lens)
    assert got.dtype == np.int64
    np.testing.assert_array_equal(
        got, verify_packed3_ref(*ops, reads.shape[1]).cpu().numpy())
    assert verify_cuda.LAUNCHES == {"verify_packed3": 1 + 5}


@pytest.mark.cuda
def test_verify_wrapper_rejects_what_the_kernel_does_not_take(cuda_device):
    codes, starts, reads, ridx, lens = verify_case(seed=5, C=128)
    ref3, w10, l10, reads3, ri, rl = verify_operands(codes, starts, reads,
                                                     ridx, lens, cuda_device)
    L = reads.shape[1]
    with pytest.raises(TypeError, match="ref3"):
        verify_cuda.verify_packed3(ref3.long(), w10, l10, reads3, ri, rl, L)
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
