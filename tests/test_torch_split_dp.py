"""The port's split-read DP (``defuse_tpu_torch.ops``) against the JAX
package: the plain PyTorch version against the XLA batch DP, the host
oracle and the Pallas kernel in interpret mode; the screen against
``screen_candidates_pallas``.  Scores are integers, so every comparison
is exact.  The kernel's own tests, which need the card, are in
``test_torch_split_dp_cuda.py``."""

import random

import numpy as np
import pytest
import torch

from defuse_tpu.align.split_dp import (MIN_SPLIT_SCORE, accept_threshold,
                                      fill_matrix)
from defuse_tpu.ops import split_dp_batch as jax_batch
from defuse_tpu_torch.convert import screen_min_scores, screen_operands
from defuse_tpu_torch.core.devices import require_cuda
from defuse_tpu_torch.ops import _build, split_dp_cuda
from defuse_tpu_torch.ops.split_dp_batch import (combine_split_scores,
                                                 dp_row_maxima, pad_batch,
                                                 screen_candidates_ref)

from torch_cases import (EDGE_CASES, SWEEP, edge_case, rand_seq, screen_case,
                         sweep_inputs, tensors, tie_rows)


@pytest.mark.parametrize("R,L", SWEEP)
def test_plain_matches_jax_batch_dp(R, L):
    refs, rl, reads, ql = sweep_inputs(R, L)
    want = np.asarray(jax_batch.dp_row_maxima(refs, rl, reads, ql))
    got = dp_row_maxima(*tensors(refs, rl, reads, ql)).numpy()
    assert got.dtype == np.int32
    np.testing.assert_array_equal(got, want)
    assert want.max() >= MIN_SPLIT_SCORE


def test_plain_matches_fill_matrix_oracle():
    rng = random.Random(11)
    refs, reads = [], []
    for _ in range(23):
        refs.append(rand_seq(rng, rng.randint(5, 127)))
        reads.append(rand_seq(rng, rng.randint(4, 40)))
    refs.append(rand_seq(rng, 127))
    reads.append(refs[-1][30:60])
    refs.append("N" * 40)
    reads.append("N" * 20)  # 'N' == 'N' counts as a match
    refs_p, ref_lens = pad_batch(refs, 128)
    reads_p, read_lens = pad_batch(reads, 48)
    rowmax = dp_row_maxima(
        *tensors(refs_p, ref_lens, reads_p, read_lens)).numpy()
    for b, (ref, read) in enumerate(zip(refs, reads)):
        m = fill_matrix(ref, read)
        for j in range(len(read) + 1):
            mx = int(m[:, j].max(initial=0))
            assert rowmax[b, j] == (mx if mx >= MIN_SPLIT_SCORE else 0), \
                (b, j)
        assert (rowmax[b, len(read) + 1:] == 0).all()
    assert rowmax[-1, 20] == 40


def test_plain_matches_pallas_interpret():
    from defuse_tpu.ops.split_dp_pallas import _dp_row_maxima_pallas
    refs, rl, reads, ql = sweep_inputs(130, 64, seed=3)
    want = np.asarray(_dp_row_maxima_pallas(
        refs.astype(np.int32), rl, reads.astype(np.int32), ql, 256, True,
        False))
    got = dp_row_maxima(*tensors(refs, rl, reads, ql)).numpy()
    np.testing.assert_array_equal(got, want)


# the Pallas kernel in interpret mode takes minutes at 1,024 rows; those
# cases hold the plain version against the XLA batch DP instead
INTERPRET = sorted(n for n, c in EDGE_CASES.items() if c[1] <= 64)


@pytest.mark.parametrize("name", INTERPRET)
def test_plain_matches_pallas_interpret_on_edge_cases(name):
    from defuse_tpu.ops.split_dp_pallas import _dp_row_maxima_pallas
    (refs, rl, reads, ql), _screen = edge_case(name)
    want = np.asarray(_dp_row_maxima_pallas(
        refs.astype(np.int32), rl, reads.astype(np.int32), ql, 256, True,
        False))
    got = dp_row_maxima(*tensors(refs, rl, reads, ql)).numpy()
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("name", sorted(EDGE_CASES))
def test_plain_matches_jax_on_edge_cases(name):
    """Row maxima against the XLA batch DP, the screen against the XLA
    screen built from it (rows, combine, threshold), on the cases a
    packed, right-aligned kernel can get wrong."""
    (refs, rl, reads, ql), screen = edge_case(name)
    want = np.asarray(jax_batch.dp_row_maxima(refs, rl, reads, ql))
    got = dp_row_maxima(*tensors(refs, rl, reads, ql)).numpy()
    np.testing.assert_array_equal(got, want)
    R, L, _B, kind = EDGE_CASES[name]
    if kind == "match":    # the int16 range's upper end: 2 * 1,023
        assert got.max() == 2 * min(R, L)
    u1, l1, u2r, l2, idx, sreads, sl, mins = screen
    rev = np.zeros_like(sreads)
    for b, n in enumerate(sl):
        rev[b, :n] = sreads[b, :n][::-1]
    rm1 = jax_batch.dp_row_maxima(u1[idx], l1[idx], sreads, sl)
    rm2 = jax_batch.dp_row_maxima(u2r[idx], l2[idx], rev, sl)
    want_s, _k = jax_batch.combine_split_scores(rm1, rm2, sl, mins)
    ops = screen_operands(*screen, "cpu")
    np.testing.assert_array_equal(
        split_dp_cuda.screen_candidates(*ops).numpy(), np.asarray(want_s))
    assert np.asarray(want_s).max() > 0


def test_combine_matches_jax():
    rng = np.random.default_rng(5)
    B, L = 32, 40
    rm1 = rng.integers(0, 30, (B, L + 1)).astype(np.int32)
    rm2 = rng.integers(0, 30, (B, L + 1)).astype(np.int32)
    ql = rng.integers(0, L + 1, B).astype(np.int32)
    mins = rng.integers(0, 50, B).astype(np.int32)
    want_s, want_k = jax_batch.combine_split_scores(rm1, rm2, ql, mins)
    got_s, got_k = combine_split_scores(*tensors(rm1, rm2, ql, mins))
    np.testing.assert_array_equal(got_s.numpy(), np.asarray(want_s))
    np.testing.assert_array_equal(got_k.numpy(), np.asarray(want_k))


def test_screen_ref_matches_pallas_screen():
    from defuse_tpu.ops.split_dp_pallas import screen_candidates_pallas
    case = screen_case()
    want = np.asarray(screen_candidates_pallas(*case))
    got = screen_candidates_ref(*tensors(*case)).numpy()
    np.testing.assert_array_equal(got, want)
    # through the operand conversion and the wrapper's CPU route
    ops = screen_operands(*case, "cpu")
    assert ops[0].shape[1] == int(max(case[1].max(), case[3].max()))
    np.testing.assert_array_equal(
        split_dp_cuda.screen_candidates(*ops).numpy(), want)
    assert want.max() > 0


def test_pad_batch_matches_jax():
    seqs = ["ACGT", "", "NNNNA", "G" * 16]
    for got, want in zip(pad_batch(seqs, 16), jax_batch.pad_batch(seqs, 16)):
        assert got.dtype == want.dtype
        np.testing.assert_array_equal(got, want)
    with pytest.raises(ValueError):
        pad_batch(["A" * 17], 16)


@pytest.mark.parametrize("lens", [[], [0, 100, 50, 100, 1, 37]])
def test_screen_min_scores_are_accept_thresholds(lens):
    got = screen_min_scores(np.array(lens, dtype=np.int32))
    assert got.dtype == np.int32
    np.testing.assert_array_equal(
        got, np.array([accept_threshold(n) for n in lens], dtype=np.int32))


@pytest.mark.parametrize("seed", [7, 8, 9])
@pytest.mark.parametrize("R,L", SWEEP)
def test_reordered_rowmax_put_back_equals_original(R, L, seed):
    """The batch sorted by read length and then flank length (the order in
    which like lengths would share the kernel's lane groups; the kernel's
    own test on the card runs it): its plain row maxima, put back, equal
    the batch's own and the JAX DP's, and the wrapper on CPU tensors gives
    the same rows without a launch."""
    refs, rl, reads, ql = sweep_inputs(R, L, seed=seed)
    order = np.lexsort((rl, ql))
    want = dp_row_maxima(*tensors(refs, rl, reads, ql)).numpy()
    got = dp_row_maxima(*tensors(refs[order], rl[order], reads[order],
                                 ql[order])).numpy()
    back = np.empty_like(got)
    back[order] = got
    np.testing.assert_array_equal(back, want)
    np.testing.assert_array_equal(
        want, np.asarray(jax_batch.dp_row_maxima(refs, rl, reads, ql)))
    split_dp_cuda.reset_launches()
    np.testing.assert_array_equal(split_dp_cuda.dp_row_maxima_cuda(
        *tensors(refs[order], rl[order], reads[order], ql[order])), got)
    assert split_dp_cuda.LAUNCHES["split_dp_rowmax"] == 0


def test_cpu_screen_launches_no_kernel():
    split_dp_cuda.reset_launches()
    ops = screen_operands(*screen_case(), "cpu")
    split_dp_cuda.screen_candidates(*ops)
    refs, rl, reads, ql = tensors(*sweep_inputs(60, 24))
    split_dp_cuda.dp_row_maxima_cuda(refs, rl, reads, ql)
    split_dp_cuda.dp_tie_columns_cuda(
        refs, rl, reads, ql, torch.from_numpy(tie_rows(ql.numpy(), 24, 3)))
    assert split_dp_cuda.LAUNCHES == {"split_dp_rowmax": 0,
                                      "split_dp_screen": 0,
                                      "split_dp_tie_columns": 0}


def test_cuda_without_cuda_raises():
    if torch.cuda.is_available():
        pytest.skip("CUDA is available here")
    with pytest.raises(RuntimeError, match="is_available"):
        require_cuda("cuda")
    assert require_cuda("cpu") == torch.device("cpu")


def test_non_cpu_tensors_never_take_the_plain_version():
    ops = [t.to("meta") for t in screen_operands(*screen_case(), "cpu")]
    with pytest.raises(ValueError, match="CUDA"):
        split_dp_cuda.screen_candidates(*ops)
    meta = [t.to("meta") for t in tensors(*sweep_inputs(60, 24))]
    with pytest.raises(ValueError, match="CUDA"):
        split_dp_cuda.dp_row_maxima_cuda(*meta)
    sel = torch.zeros((16, 2), dtype=torch.int32, device="meta")
    with pytest.raises(ValueError, match="CUDA"):
        split_dp_cuda.dp_tie_columns_cuda(*meta, sel)


@pytest.mark.parametrize("field,value", [
    ("ref_idx", 5), ("ref_idx", -1), ("read_lens", 25), ("u1l", 129)])
def test_screen_operands_rejects_out_of_range(field, value):
    case = list(screen_case())
    pos = {"u1l": 1, "ref_idx": 4, "read_lens": 6}[field]
    case[pos] = case[pos].copy()
    case[pos][0] = value
    with pytest.raises(ValueError, match=field):
        screen_operands(*case, "cpu")


def test_failed_build_raises_with_nvcc_stderr(tmp_path, monkeypatch):
    fake = tmp_path / "nvcc"
    fake.write_text("#!/bin/sh\necho 'error: no such intrinsic' >&2\n"
                    "exit 2\n")
    fake.chmod(0o755)
    monkeypatch.setattr(_build, "find_nvcc", lambda: str(fake))
    monkeypatch.setattr(_build, "BUILD_DIR", tmp_path / "kernels")
    with pytest.raises(RuntimeError, match="no such intrinsic"):
        _build.build("split_dp")
    assert not list((tmp_path / "kernels").glob("*.so"))
