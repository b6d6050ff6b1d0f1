"""The port's ``dp_tie_columns`` (plain PyTorch) and its kernel's wrapper
``dp_tie_columns_cuda`` on CPU tensors (which takes the plain version and
launches nothing) against ``defuse_tpu.ops.split_dp_batch.dp_tie_columns``
on the same seeded inputs.  Tolerance: none.  The anchored row maxima are
equal integers and the packed tie masks are equal byte for byte (the port
returns the uint32 words' pattern as int32).  The kernel itself is held to
the plain version on the card by ``test_torch_split_dp_cuda.py``."""

import numpy as np
import pytest
import torch

from defuse_tpu.align import batch_realign as jax_realign
from defuse_tpu.align.split_dp import MIN_SPLIT_SCORE
from defuse_tpu.ops import split_dp_batch as jax_dp
from defuse_tpu_torch import convert
from defuse_tpu_torch.align import batch_realign as port_realign
from defuse_tpu_torch.ops import split_dp_batch as port_dp
from defuse_tpu_torch.ops import split_dp_cuda

from torch_cases import (EDGE_CASES, SWEEP, edge_case, sweep_inputs,
                         tensors, tie_boundary_case, tie_rows)

IMPLS = {"plain": port_dp.dp_tie_columns,
         "wrapper": split_dp_cuda.dp_tie_columns_cuda}

# the cases with reads of 1024 columns take the JAX scan a minute to trace
FAST_EDGE_CASES = sorted(n for n in EDGE_CASES if not n.startswith("L1024"))


def row_selection(ref_lens, read_lens, L, M, seed):
    """(B, M) rows to capture: row 0, the read's last row, the matrix's
    last row L, unused slots (-1) and random rows."""
    rng = np.random.default_rng(seed)
    B = len(read_lens)
    sel = rng.integers(-1, L + 1, (B, M)).astype(np.int32)
    sel[:, 0] = read_lens          # the row a full-length split asks for
    sel[0::3, 1] = 0               # the initial all-zero row
    sel[1::3, 1] = L
    sel[2::3, 1] = -1
    return sel


def both(refs, rl, reads, ql, sel, impl="plain"):
    want_max, want_packed = jax_dp.dp_tie_columns(refs, rl, reads, ql, sel)
    split_dp_cuda.reset_launches()
    got_max, got_packed = IMPLS[impl](
        *convert.tie_operands(refs, rl, reads, ql, sel, "cpu"))
    assert split_dp_cuda.LAUNCHES["split_dp_tie_columns"] == 0
    return (np.asarray(want_max), np.asarray(want_packed),
            got_max.numpy(), got_packed.numpy())


def assert_same(want_max, want_packed, got_max, got_packed):
    assert got_max.dtype == np.int32 and got_packed.dtype == np.int32
    assert want_packed.dtype == np.uint32
    np.testing.assert_array_equal(got_max, want_max)
    assert got_packed.shape == want_packed.shape
    assert got_packed.tobytes() == want_packed.tobytes()


@pytest.mark.parametrize("impl", sorted(IMPLS))
@pytest.mark.parametrize("R,L", SWEEP)
def test_tie_columns_match_jax_on_sweep(R, L, impl):
    refs, rl, reads, ql = sweep_inputs(R, L)
    sel = row_selection(rl, ql, L, 4, seed=R + L)
    out = both(refs, rl, reads, ql, sel, impl)
    assert_same(*out)
    assert out[1].any(), "no tie column set: the case checks nothing"


@pytest.mark.parametrize("impl", sorted(IMPLS))
@pytest.mark.parametrize("name", FAST_EDGE_CASES)
def test_tie_columns_match_jax_on_edge_cases(name, impl):
    (refs, rl, reads, ql), _screen = edge_case(name)
    L = reads.shape[1]
    sel = row_selection(rl, ql, L, 3, seed=len(name))
    want_max, want_packed, got_max, got_packed = both(refs, rl, reads, ql,
                                                      sel, impl)
    assert_same(want_max, want_packed, got_max, got_packed)
    R = refs.shape[1]
    assert want_packed.shape[2] == (R + 1 + 31) // 32
    # a row under the anchor gets max 0 and no column
    low = want_max == 0
    assert low.any() and not want_packed[low].any()


@pytest.mark.parametrize("impl", sorted(IMPLS))
@pytest.mark.parametrize("case", ["boundary", (60, 24), (257, 64)])
def test_tie_columns_edge_rows_match_jax(case, impl):
    """Every edge row the kernel must treat as the plain version does
    (``tie_rows``: the read's last row, the one past it, L, 0, -1, a
    duplicate), and flanks whose last column sits on either side of a
    32-column word."""
    refs, rl, reads, ql = tie_boundary_case() if case == "boundary" \
        else sweep_inputs(*case)
    L = reads.shape[1]
    sel = tie_rows(ql, L, 7, seed=L + len(rl))
    out = both(refs, rl, reads, ql, sel, impl)
    assert_same(*out)
    want_max, want_packed = out[:2]
    assert (sel == -1).any() and (sel == 0).any() and (sel == L).any()
    assert not want_packed[(sel < 1)].any()
    if case == "boundary":
        # a tie reaches the last column of each flank of 31 and 63 bases
        # (bit 31 of words 0 and 1) and crosses into the next word at 32
        # and 64
        bits = np.unpackbits(want_packed.view(np.uint8), axis=-1,
                             bitorder="little")
        for b, last in ((1, 31), (2, 32), (4, 63), (5, 64)):
            assert bits[b, :, last].any(), (b, last)


def test_tie_columns_sign_bit_and_row_zero():
    """Column 31 of a word lands in the int32's sign bit; row 0 is the
    all-zero row, whose maximum (0) is under the anchor."""
    R, L = 63, 40
    refs = np.full((2, R), ord("A"), np.uint8)
    reads = np.full((2, L), ord("A"), np.uint8)
    rl = np.array([31, 63], np.int32)
    ql = np.array([31, 31], np.int32)
    sel = np.array([[31, 0], [31, -1]], np.int32)
    want_max, want_packed, got_max, got_packed = both(refs, rl, reads, ql,
                                                      sel)
    assert_same(want_max, want_packed, got_max, got_packed)
    assert want_max[0, 0] >= MIN_SPLIT_SCORE and want_max[0, 1] == 0
    assert want_packed[0, 0, 0] == 1 << 31 and got_packed[0, 0, 0] < 0


@pytest.mark.parametrize("field,value", [("row_sel", 25), ("row_sel", -2),
                                         ("read_lens", 25),
                                         ("ref_lens", 61)])
def test_tie_operands_refuse_out_of_range(field, value):
    refs, rl, reads, ql = sweep_inputs(60, 24)
    sel = row_selection(rl, ql, 24, 2, seed=1)
    arrays = dict(ref_lens=rl, read_lens=ql, row_sel=sel)
    arrays[field] = arrays[field].copy()
    arrays[field].flat[0] = value
    with pytest.raises(ValueError, match=field):
        convert.tie_operands(refs, arrays["ref_lens"], reads,
                             arrays["read_lens"], arrays["row_sel"], "cpu")


def test_tie_operands_need_cuda_when_asked():
    if torch.cuda.is_available():
        pytest.skip("CUDA is available here")
    with pytest.raises(RuntimeError, match="is_available"):
        port_realign._device_tie_columns([(["ACGT"], ["ACGT"], [[4]], [4])],
                                         [0], 128, 1, device="cuda")


@pytest.mark.parametrize("seed", [3, 4])
def test_device_tie_columns_dict_matches_jax(seed):
    """``_device_tie_columns`` on one side, through ``dp_tie_columns_cuda``
    on CPU tensors: the {(candidate, row): columns} dict equals the JAX
    package's (both sides in one call: ``test_torch_tie_kernel.py``)."""
    rng = np.random.default_rng(seed)
    refs, reads, wanted, lens = [], [], [], []
    for b in range(9):
        n_ref, n_read = int(rng.integers(30, 120)), int(rng.integers(20, 60))
        ref = "".join(rng.choice(list("ACGT"), n_ref))
        start = int(rng.integers(0, max(1, n_ref - n_read)))
        read = ref[start:start + n_read] if b % 2 == 0 else \
            "".join(rng.choice(list("ACGT"), n_read))
        refs.append(ref)
        reads.append(read)
        lens.append(len(ref))
        wanted.append(sorted({len(read), len(read) // 2, 0}
                             if b % 3 else {len(read)}))
    win_idx = [10 + b for b in range(9)]
    lens = np.array(lens, np.int32)
    want = jax_realign._device_tie_columns(refs, reads, wanted, win_idx, 128,
                                           3, lens)
    split_dp_cuda.reset_launches()
    got, = port_realign._device_tie_columns([(refs, reads, wanted, lens)],
                                            win_idx, 128, 3, device="cpu")
    assert got == want
    assert split_dp_cuda.LAUNCHES["split_dp_tie_columns"] == 0
    assert any(want.values()) and not all(want.values())
