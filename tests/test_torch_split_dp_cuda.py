"""The CUDA kernels of ``defuse_tpu_torch/csrc/split_dp.cu`` against their
plain PyTorch versions on the card, exactly: the screen, the row maxima
(also with the batch sorted so that like lengths share a lane group) and
the tie columns.  Skips where CUDA is absent.  Imports no ``jax``, so it also runs
on a machine without it:

    python -m pytest --noconftest -p no:cacheprovider \\
        tests/test_torch_split_dp_cuda.py
"""

import numpy as np
import pytest
import torch

from defuse_tpu_torch.convert import screen_operands
from defuse_tpu_torch.ops import split_dp_cuda
from defuse_tpu_torch.ops.split_dp_batch import (dp_row_maxima,
                                                 dp_tie_columns,
                                                 screen_candidates_ref)

from torch_cases import (EDGE_CASES, SWEEP, edge_case, screen_case,
                         sweep_inputs, tensors, tie_boundary_case, tie_rows)


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU")
    return torch.device("cuda")


def tie_inputs(name):
    """(refs, ref_lens, reads, read_lens, row_sel) of a sweep shape, an
    edge case or the word-boundary case, with every edge row selected."""
    if name == "boundary":
        refs, rl, reads, ql = tie_boundary_case()
    elif isinstance(name, tuple):
        refs, rl, reads, ql = sweep_inputs(*name)
    else:
        (refs, rl, reads, ql), _screen = edge_case(name)
    L = reads.shape[1]
    return refs, rl, reads, ql, tie_rows(ql, L, 7, seed=L + len(rl))


def assert_tie_equal(device, arrays):
    ts = [t.to(device) for t in tensors(*arrays)]
    got = split_dp_cuda.dp_tie_columns_cuda(*ts)
    want = dp_tie_columns(*ts)
    for g, w in zip(got, want):
        torch.testing.assert_close(g, w, rtol=0, atol=0)
    return want


@pytest.mark.cuda
@pytest.mark.parametrize("R,L", SWEEP + ((512, 128),))
def test_kernel_matches_plain_on_card(cuda_device, R, L):
    refs, rl, reads, ql = (t.to(cuda_device)
                           for t in tensors(*sweep_inputs(R, L)))
    got = split_dp_cuda.dp_row_maxima_cuda(refs, rl, reads, ql)
    torch.testing.assert_close(got, dp_row_maxima(refs, rl, reads, ql),
                               rtol=0, atol=0)
    ops = screen_operands(*screen_case(), cuda_device)
    torch.testing.assert_close(split_dp_cuda.screen_candidates(*ops),
                               screen_candidates_ref(*ops), rtol=0, atol=0)


@pytest.mark.cuda
@pytest.mark.parametrize("name", sorted(EDGE_CASES))
def test_kernel_matches_plain_on_edge_cases(cuda_device, name):
    rowmax_in, screen_in = edge_case(name)
    ts = [t.to(cuda_device) for t in tensors(*rowmax_in)]
    torch.testing.assert_close(split_dp_cuda.dp_row_maxima_cuda(*ts),
                               dp_row_maxima(*ts), rtol=0, atol=0)
    ops = screen_operands(*screen_in, cuda_device)
    want = screen_candidates_ref(*ops)
    torch.testing.assert_close(split_dp_cuda.screen_candidates(*ops), want,
                               rtol=0, atol=0)
    assert int(want.max()) > 0


@pytest.mark.cuda
@pytest.mark.parametrize("R,L", SWEEP + ((512, 128), (1023, 1024)))
def test_reordered_rowmax_matches_plain(cuda_device, R, L):
    """Mixed flank and read lengths in one batch, in the caller's order and
    sorted by length (other instances share each lane group)."""
    arrays = sweep_inputs(R, L, B=45)
    order = np.lexsort((arrays[1], arrays[3]))
    for batch in (arrays, [a[order] for a in arrays]):
        ts = [t.to(cuda_device) for t in tensors(*batch)]
        torch.testing.assert_close(split_dp_cuda.dp_row_maxima_cuda(*ts),
                                   dp_row_maxima(*ts), rtol=0, atol=0)


@pytest.mark.cuda
@pytest.mark.parametrize("shape", SWEEP + ((512, 128),))
def test_tie_kernel_matches_plain_on_sweep(cuda_device, shape):
    _rowmax, packed = assert_tie_equal(cuda_device, tie_inputs(shape))
    assert bool(packed.any())


@pytest.mark.cuda
@pytest.mark.parametrize("name", sorted(EDGE_CASES) + ["boundary"])
def test_tie_kernel_matches_plain_on_edge_cases(cuda_device, name):
    assert_tie_equal(cuda_device, tie_inputs(name))


@pytest.mark.cuda
def test_tie_kernel_with_many_rows(cuda_device):
    """40 rows an instance: more captured rows than a lane group keeps, so
    the kernel runs its DP a second time."""
    arrays = sweep_inputs(200, 64, seed=3, B=24)
    _rowmax, packed = assert_tie_equal(
        cuda_device, (*arrays, tie_rows(arrays[3], 64, 40, seed=9)))
    assert bool(packed.any())


@pytest.mark.cuda
def test_one_tie_launch_for_both_sides(cuda_device):
    """``realign_candidates``'s one call of both sides: one launch, and each
    side's {(candidate, row): columns} map equal to the call on CPU
    tensors."""
    from defuse_tpu_torch.align.batch_realign import _device_tie_columns
    rng = np.random.default_rng(5)
    refs = ["".join(rng.choice(list("ACGT"), int(rng.integers(150, 210))))
            for _ in range(40)]
    reads = [r[-25:] + "".join(rng.choice(list("ACGT"), 25)) for r in refs]
    sides = [(refs[:20], reads[:20], [[25, 50]] * 20,
              np.array([len(r) for r in refs[:20]], np.int32)),
             (refs[20:], reads[20:], [[25, 0]] * 20,
              np.array([len(r) for r in refs[20:]], np.int32))]
    win_idx = list(range(20))
    want = _device_tie_columns(sides, win_idx, 256, 2, device="cpu")
    split_dp_cuda.reset_launches()
    got = _device_tie_columns(sides, win_idx, 256, 2, device="cuda")
    assert split_dp_cuda.LAUNCHES["split_dp_tie_columns"] == 1
    assert got == want and any(want[0].values())


@pytest.mark.cuda
def test_launches_are_counted_on_card(cuda_device):
    split_dp_cuda.reset_launches()
    ops = screen_operands(*screen_case(), cuda_device)
    split_dp_cuda.screen_candidates(*ops)
    split_dp_cuda.dp_row_maxima_cuda(
        *(t.to(cuda_device) for t in tensors(*sweep_inputs(60, 24))))
    split_dp_cuda.dp_tie_columns_cuda(
        *(t.to(cuda_device) for t in tensors(*tie_inputs((60, 24)))))
    torch.cuda.synchronize()
    assert split_dp_cuda.LAUNCHES == {"split_dp_rowmax": 1,
                                      "split_dp_screen": 1,
                                      "split_dp_tie_columns": 1}


@pytest.mark.cuda
def test_wrapper_rejects_what_the_kernel_does_not_take(cuda_device):
    refs, rl, reads, ql, sel = (t.to(cuda_device)
                                for t in tensors(*tie_inputs((60, 24))))
    with pytest.raises(TypeError, match="reads"):
        split_dp_cuda.dp_row_maxima_cuda(refs, rl, reads.int(), ql)
    with pytest.raises(ValueError, match="contiguous"):
        split_dp_cuda.dp_row_maxima_cuda(refs[:, ::2], rl, reads, ql)
    wide = torch.zeros((16, 1024), dtype=torch.uint8, device=cuda_device)
    with pytest.raises(ValueError, match="flank width"):
        split_dp_cuda.dp_row_maxima_cuda(wide, rl, reads, ql)
    with pytest.raises(TypeError, match="row_sel"):
        split_dp_cuda.dp_tie_columns_cuda(refs, rl, reads, ql, sel.long())
    with pytest.raises(ValueError, match="row_sel"):
        split_dp_cuda.dp_tie_columns_cuda(refs, rl, reads, ql, sel[:3])
    with pytest.raises(ValueError, match="flank width"):
        split_dp_cuda.dp_tie_columns_cuda(wide, rl, reads, ql, sel)
    with pytest.raises(ValueError, match="ref_lens"):
        split_dp_cuda.dp_tie_columns_cuda(refs, rl.cpu(), reads, ql, sel)
