"""The port's packed verify against ``defuse_tpu``'s: the plain PyTorch
version equals the JAX ``_verify_packed3`` (plain ``jnp`` on the CPU) and
the ``SeedIndex.verify`` numpy oracle, exactly (integer counts,
tolerance 0); ``DeviceVerifier(device="cpu")`` behind
``SeedIndex.align_batch`` gives the numpy path's hits."""

import random

import numpy as np
import pytest
import torch

from defuse_tpu.align.seedindex import SeedIndex
from defuse_tpu.ops import verify_batch as jax_verify
from defuse_tpu_torch.convert import (MAX_VERIFY_BASES, verify_operands,
                                      verify_plane)
from defuse_tpu_torch.ops import verify_batch, verify_cuda

from torch_cases import verify_case

CASES = [dict(seed=7), dict(seed=11, n_ref=1000, L=50, B=32, C=2048),
         dict(seed=13, n_ref=200, L=10, B=8, C=256),
         dict(seed=17, n_ref=999, L=101, B=16, C=1024)]


def oracle(codes, starts, reads, ridx, lens):
    """``SeedIndex.verify``'s numpy count (clipped gather, length mask)."""
    L = reads.shape[1]
    idx = np.clip(starts[:, None] + np.arange(L)[None, :], 0, len(codes) - 1)
    return ((codes[idx] != reads[ridx])
            & (np.arange(L)[None, :] < lens[ridx][:, None])).sum(axis=1)


@pytest.mark.parametrize("case", CASES, ids=lambda c: f"seed{c['seed']}")
def test_plain_matches_jax_and_oracle(case):
    codes, starts, reads, ridx, lens = verify_case(**case)
    L = reads.shape[1]
    ops = verify_operands(codes, starts, reads, ridx, lens, "cpu")
    got = verify_batch.verify_packed3_ref(*ops, L).numpy()
    # through the wrapper: a CPU tensor takes the plain version
    np.testing.assert_array_equal(verify_cuda.verify_packed3(*ops, L).numpy(),
                                  got)

    clipped = np.clip(starts, 0, len(codes) - 1)
    want_jax = np.asarray(jax_verify._verify_packed3(
        jax_verify.pack_codes3(codes), (clipped // 10).astype(np.int32),
        (clipped % 10).astype(np.int32), jax_verify.pack_rows3(reads), ridx,
        lens, L))
    np.testing.assert_array_equal(got, want_jax)
    # the oracle repeats the last base past the reference end where the
    # packed plane reads padding: the two agree on in-bounds placements,
    # the only ones SeedIndex.verify keeps
    inside = clipped + lens[ridx] <= len(codes)
    assert inside.sum() > len(starts) // 2
    np.testing.assert_array_equal(
        got[inside], oracle(codes, clipped, reads, ridx, lens)[inside])
    assert got.max() > 0 and (got == 0).any()


@pytest.mark.parametrize("case", CASES[:2], ids=lambda c: f"seed{c['seed']}")
def test_packing_matches_jax(case):
    codes, _starts, reads, _ridx, _lens = verify_case(**case)
    np.testing.assert_array_equal(verify_batch.pack_codes3(codes),
                                  jax_verify.pack_codes3(codes))
    np.testing.assert_array_equal(verify_batch.pack_rows3(reads),
                                  jax_verify.pack_rows3(reads))
    plane = verify_plane(codes, "cpu")
    assert plane.dtype == torch.int32
    assert plane.shape == ((len(codes) + 9) // 10,)
    assert int(plane.max()) < 1 << 30


def test_every_lane_and_length_edge():
    """Each lane of a known window, each read length at the word edges:
    the count is the number of planted mismatches inside the length."""
    rng = np.random.default_rng(3)
    codes = rng.integers(0, 4, 300).astype(np.int8)
    for lane in range(10):
        start = 120 + lane
        for n in (0, 1, 9, 10, 11, 20, 21, 30):
            read = codes[start:start + 30].copy()
            read[[0, 9, 10, 19, 29]] = (read[[0, 9, 10, 19, 29]] + 1) % 4
            want = sum(p < n for p in (0, 9, 10, 19, 29))
            ops = verify_operands(codes, [start], read[None, :], [0], [n],
                                  "cpu")
            assert int(verify_batch.verify_packed3_ref(*ops, 30)[0]) == want


def test_n_equals_n():
    codes = np.full(40, 4, np.int8)
    reads = np.full((2, 12), 4, np.int8)
    reads[1, 5] = 0
    ops = verify_operands(codes, [3, 3], reads, [0, 1], [12, 12], "cpu")
    assert verify_batch.verify_packed3_ref(*ops, 12).tolist() == [0, 1]


def test_plain_takes_int64_words():
    codes, starts, reads, ridx, lens = verify_case(seed=5, C=512)
    ops = verify_operands(codes, starts, reads, ridx, lens, "cpu")
    wide = (ops[0].long(),) + ops[1:3] + (ops[3].long(),) + ops[4:]
    L = reads.shape[1]
    torch.testing.assert_close(verify_batch.verify_packed3_ref(*wide, L),
                               verify_batch.verify_packed3_ref(*ops, L),
                               rtol=0, atol=0)


def test_cpu_wrapper_counts_no_launch():
    verify_cuda.reset_launches()
    codes, starts, reads, ridx, lens = verify_case(seed=9, C=64)
    ops = verify_operands(codes, starts, reads, ridx, lens, "cpu")
    verify_cuda.verify_packed3(*ops, reads.shape[1])
    assert verify_cuda.LAUNCHES == {"verify_packed3": 0}


def test_verify_operands_split_and_clip():
    codes = np.zeros(105, np.int8)
    reads = np.zeros((3, 10), np.int8)
    _ref3, w10, l10, reads3, ridx, lens = verify_operands(
        codes, [-5, 0, 9, 10, 57, 104, 400], reads, [0, 1, 2, 0, 1, 2, 0],
        [10, 10, 10], "cpu")
    assert w10.tolist() == [0, 0, 0, 1, 5, 10, 10]
    assert l10.tolist() == [0, 0, 9, 0, 7, 4, 4]
    assert reads3.shape == (3, 1) and reads3.dtype == torch.int32
    assert ridx.dtype == lens.dtype == torch.int32


@pytest.mark.parametrize("bad", ["codes", "reads", "read_idx", "read_lens"])
def test_verify_operands_rejects(bad):
    codes = np.zeros(50, np.int8)
    reads = np.zeros((2, 10), np.int8)
    ridx, lens = [0, 1], [10, 10]
    if bad == "codes":
        codes[3] = 5
    elif bad == "reads":
        reads[1, 2] = -1
    elif bad == "read_idx":
        ridx = [0, 2]
    else:
        lens = [10]
    with pytest.raises(ValueError, match=bad):
        verify_operands(codes, [0, 7], reads, ridx, lens, "cpu")


def test_verify_operands_raises_past_21_gbp():
    """References of 2^31 * 10 bases or more leave int32 word indices."""
    huge = np.broadcast_to(np.int8(0), (MAX_VERIFY_BASES,))  # no memory
    with pytest.raises(NotImplementedError, match="21 Gbp"):
        verify_operands(huge, [0], np.zeros((1, 10), np.int8), [0], [10],
                        "cpu")
    with pytest.raises(NotImplementedError, match="21 Gbp"):
        verifier = verify_batch.DeviceVerifier("cpu")
        verifier(huge, np.zeros(1, np.int64), np.zeros((1, 10), np.int8),
                 np.zeros(1, np.int64), np.full(1, 10))


def reads_of(seqs, rng, n=40, length=50):
    reads = []
    for _ in range(n):
        src = seqs[rng.choice(sorted(seqs))]
        p = rng.randint(0, len(src) - length)
        read = list(src[p:p + length])
        for _ in range(rng.randint(0, 2)):
            i = rng.randrange(length)
            read[i] = rng.choice([c for c in "ACGT" if c != read[i]])
        reads.append("".join(read))
    return reads


def norm(res):
    return [None if hits is None else
            sorted((a.ref, a.pos, a.strand, a.mismatches) for a in hits)
            for hits in res]


@pytest.mark.parametrize("batch", [512, 1 << 17])
def test_device_verifier_matches_numpy(batch):
    """Mirror of test_verify_batch's check, with the port's verifier."""
    rng = random.Random(21)
    seqs = {"A": "".join(rng.choice("ACGT") for _ in range(8000)),
            "B": "".join(rng.choice("ACGT") for _ in range(5000))}
    index = SeedIndex(seqs)
    reads = reads_of(seqs, rng)
    verifier = verify_batch.DeviceVerifier("cpu", batch=batch)
    plain = index.align_batch(reads)
    dev = index.align_batch(reads, verify_fn=verifier)
    assert norm(plain) == norm(dev)
    assert sum(len(h) for h in dev if h) >= len(reads)
    # one resident plane per reference array, reused across calls
    assert len(verifier._resident) == 1
    index.align_batch(reads, verify_fn=verifier)
    assert len(verifier._resident) == 1


def test_device_verifier_returns_int64_counts():
    codes, starts, reads, ridx, lens = verify_case(seed=19, C=700)
    verifier = verify_batch.DeviceVerifier("cpu", batch=256)
    got = verifier(codes, starts, reads, ridx, lens)
    assert got.dtype == np.int64 and got.shape == (700,)
    ops = verify_operands(codes, starts, reads, ridx, lens, "cpu")
    np.testing.assert_array_equal(
        got, verify_batch.verify_packed3_ref(*ops, reads.shape[1]).numpy())
