"""The port's packed verify against ``defuse_tpu``'s: the plain PyTorch
version equals the JAX ``_verify_packed3`` (plain ``jnp`` on the CPU) and
the ``SeedIndex.verify`` numpy oracle, exactly (integer counts,
tolerance 0); ``DeviceVerifier(device="cpu")`` behind
``SeedIndex.align_batch``, its device route forced
(``DEFUSE_DEVICE_VERIFY=force``), gives the numpy path's hits; the roofline
legs' plain versions equal their definitions in
``scripts_dev/verify_roofline_probe.py`` (through JAX on the CPU), modulo
2^32; the bound's work count on inputs counted by hand."""

import importlib.util
import pathlib
import random

import numpy as np
import pytest
import torch

from defuse_tpu.align.seedindex import SeedIndex
from defuse_tpu.ops import verify_batch as jax_verify
from defuse_tpu_torch.convert import (MAX_VERIFY_BASES, verify_operands,
                                      verify_plane)
from defuse_tpu_torch.ops import verify_batch, verify_cuda, verify_roofline

from torch_cases import verify_case, verify_genome_case


@pytest.fixture(autouse=True)
def device_route(monkeypatch):
    """Every verifier call on its device route (the plain version here),
    whatever the cost model would pick."""
    monkeypatch.setenv("DEFUSE_DEVICE_VERIFY", "force")

# seed 7 has L = 53: six words a row, a width no read length of a
# sequencer gives; 100 and 150 are the widths of 16 lanes a candidate
CASES = [dict(seed=7), dict(seed=11, n_ref=1000, L=50, B=32, C=2048),
         dict(seed=13, n_ref=200, L=10, B=8, C=256),
         dict(seed=17, n_ref=999, L=101, B=16, C=1024),
         dict(seed=19, n_ref=3000, L=100, B=32, C=1024),
         dict(seed=23, n_ref=3000, L=150, B=32, C=1024),
         dict(seed=29, n_ref=2000, L=53, B=32, C=1024, order="sorted"),
         dict(seed=31, n_ref=4000, L=100, B=64, C=2048, order="sorted"),
         dict(seed=37, n_ref=4000, L=320, B=8, C=256)]


def case_inputs(seed, order="as_drawn", **kw):
    """``verify_case``, its candidates sorted by (read, position) as
    ``SeedIndex.candidates`` hands them over when ``order`` says so."""
    codes, starts, reads, ridx, lens = verify_case(seed=seed, **kw)
    if order == "sorted":
        by = np.lexsort((starts, ridx))
        starts, ridx = starts[by], ridx[by]
        assert (np.diff(ridx) >= 0).all()
    return codes, starts, reads, ridx, lens


def case_id(case):
    return f"seed{case['seed']}"


def oracle(codes, starts, reads, ridx, lens):
    """``SeedIndex.verify``'s numpy count (clipped gather, length mask)."""
    L = reads.shape[1]
    idx = np.clip(starts[:, None] + np.arange(L)[None, :], 0, len(codes) - 1)
    return ((codes[idx] != reads[ridx])
            & (np.arange(L)[None, :] < lens[ridx][:, None])).sum(axis=1)


@pytest.mark.parametrize("case", CASES, ids=case_id)
def test_plain_matches_jax_and_oracle(case):
    codes, starts, reads, ridx, lens = case_inputs(**case)
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


@pytest.mark.parametrize("case", CASES[:2], ids=case_id)
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
    for leg in verify_cuda.LEGS:
        verify_roofline.verify_leg(leg, *ops, reads.shape[1])
    assert verify_cuda.LAUNCHES == {"verify_packed3": 0, "verify_gather": 0,
                                    "verify_compute": 0}


def test_verify_operands_split_and_clip():
    codes = np.zeros(105, np.int8)
    reads = np.zeros((3, 10), np.int8)
    _ref3, w10, l10, reads3, ridx, lens = verify_operands(
        codes, [-5, 0, 9, 10, 57, 104, 400], reads, [0, 1, 2, 0, 1, 2, 0],
        [10, 10, 10], "cpu")
    assert w10.tolist() == [0, 0, 0, 1, 5, 10, 10]
    assert l10.tolist() == [0, 0, 9, 0, 7, 4, 4]
    assert reads3.shape == (3, 1) and reads3.dtype == torch.int32
    assert w10.dtype == ridx.dtype == lens.dtype == torch.int32
    assert l10.dtype == torch.uint8


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


@pytest.mark.parametrize("length", [50, 100])
def test_device_verifier_matches_numpy(length):
    """Mirror of test_verify_batch's check, with the port's verifier."""
    rng = random.Random(21)
    seqs = {"A": "".join(rng.choice("ACGT") for _ in range(8000)),
            "B": "".join(rng.choice("ACGT") for _ in range(5000))}
    index = SeedIndex(seqs)
    reads = reads_of(seqs, rng, length=length)
    verifier = verify_batch.DeviceVerifier("cpu")
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
    verifier = verify_batch.DeviceVerifier("cpu")
    got = verifier(codes, starts, reads, ridx, lens)
    assert got.dtype == np.int64 and got.shape == (700,)
    ops = verify_operands(codes, starts, reads, ridx, lens, "cpu")
    np.testing.assert_array_equal(
        got, verify_batch.verify_packed3_ref(*ops, reads.shape[1]).numpy())


def test_device_verifier_one_call_equals_batches_and_numpy():
    """All candidates in one call of the plain version, the same candidates
    cut into batches, and ``SeedIndex.verify`` without a verifier keep the
    same placements with the same counts."""
    rng = random.Random(5)
    a = "".join(rng.choice("ACGT") for _ in range(6000))
    # a second copy with every 40th base changed: two candidates for most
    # reads
    b = "".join("ACGT"[("ACGT".index(c) + 1) % 4] if i % 40 == 0 else c
                for i, c in enumerate(a))
    seqs = {"A": a, "B": b}
    index = SeedIndex(seqs)
    reads = reads_of(seqs, rng, n=60)
    codes = np.full((len(reads), 50), 4, np.int8)
    for i, r in enumerate(reads):
        codes[i] = ["ACGT".index(c) for c in r]
    lens = np.full(len(reads), 50, np.int64)
    ridx, cpos = index.candidates(codes)
    assert len(ridx) > 1.5 * len(reads) and (np.diff(ridx) >= 0).all()
    want = index.verify(codes, lens, ridx, cpos)
    assert len(want[0]) >= len(reads)
    one = verify_batch.DeviceVerifier("cpu")

    def cut(ref_codes, pos, read_codes, idx, read_lens, step=37):
        return np.concatenate([
            one(ref_codes, pos[lo:lo + step], read_codes, idx[lo:lo + step],
                read_lens) for lo in range(0, len(pos), step)])

    np.testing.assert_array_equal(
        one(index.codes, cpos, codes, ridx, lens),
        cut(index.codes, cpos, codes, ridx, lens))
    for verifier in (one, cut):
        got = index.verify(codes, lens, ridx, cpos, verify_fn=verifier)
        for a, b in zip(got, want):
            np.testing.assert_array_equal(a, b)


def test_port_align_batch_calls_the_verifier_once_a_strand():
    """The port's ``SeedIndex.align_batch`` hands each strand's candidates
    to the verifier in one call (one launch on the card) and returns the
    reference's hits in the reference's order, with and without a
    verifier."""
    from defuse_tpu_torch.align.seedindex import SeedIndex as PortIndex
    rng = random.Random(33)
    seqs = {"A": "".join(rng.choice("ACGT") for _ in range(7000)),
            "B": "".join(rng.choice("ACGT") for _ in range(4000))}
    comp = str.maketrans("ACGT", "TGCA")
    reads = [r.translate(comp)[::-1] if i % 2 else r
             for i, r in enumerate(reads_of(seqs, rng, n=50))]
    reads.append("ACGT" * 5)  # a shorter read, padded with N

    def hits(res):
        return [None if h is None else
                [(a.ref, a.pos, a.strand, a.mismatches) for a in h]
                for h in res]

    want = hits(SeedIndex(seqs).align_batch(reads))
    assert {s for h in want for _r, _p, s, _m in h} == {0, 1}
    verifier = verify_batch.DeviceVerifier("cpu")
    calls = []

    def counting(*args):
        calls.append(len(args[1]))
        return verifier(*args)

    port = PortIndex(seqs)
    assert hits(port.align_batch(reads, verify_fn=counting)) == want
    assert len(calls) == 2 and sum(calls) >= len(reads) - 1
    # without a verifier and without the native library: the numpy count
    assert hits(port.align_batch(reads, verify_fn=lambda codes, pos, rc, ri,
                                 rl: oracle(codes, np.clip(pos, 0, None),
                                            rc, ri, rl))) == want
    assert port.align_batch([]) == []


def roofline_probe():
    """``scripts_dev/verify_roofline_probe.py`` as a module."""
    path = pathlib.Path(__file__).resolve().parent.parent / "scripts_dev" / \
        "verify_roofline_probe.py"
    spec = importlib.util.spec_from_file_location("verify_roofline_probe",
                                                  path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@pytest.mark.parametrize("L", [50, 100])
@pytest.mark.parametrize("leg", ["gather", "compute"])
def test_leg_plain_versions_match_the_probe(leg, L, monkeypatch):
    """The probe's legs return one sum over all candidates (uint32); the
    port's return a checksum per candidate.  Their sum modulo 2^32 is the
    probe's number, for all candidates and for each of the first eight
    alone."""
    probe = roofline_probe()
    monkeypatch.setattr(probe, "W", verify_batch.packed_words(L))
    codes, starts, reads, ridx, lens = verify_case(seed=41 + L, n_ref=3000,
                                                   L=L, B=16, C=512)
    ops = verify_operands(codes, starts, reads, ridx, lens, "cpu")
    ours = verify_roofline.verify_leg(leg, *ops, L).to(torch.int64)
    ref3 = jax_verify.pack_codes3(codes)
    reads3 = jax_verify.pack_rows3(reads)
    clipped = np.clip(starts, 0, len(codes) - 1)
    w10 = (clipped // 10).astype(np.int32)
    l10 = (clipped % 10).astype(np.int32)

    def theirs(sel):
        if leg == "gather":
            v = probe.gather_only(ref3, w10[sel], l10[sel], reads3, ridx[sel])
        else:
            v = probe.compute_only(ref3, w10[sel], l10[sel], reads3,
                                   ridx[sel], lens)
        return int(np.asarray(v)) % (1 << 32)

    assert int(ours.sum()) % (1 << 32) == theirs(slice(None))
    for i in range(8):
        assert int(ours[i]) % (1 << 32) == theirs(slice(i, i + 1))


def test_full_leg_is_the_plain_version():
    codes, starts, reads, ridx, lens = verify_case(seed=43, C=300)
    ops = verify_operands(codes, starts, reads, ridx, lens, "cpu")
    L = reads.shape[1]
    torch.testing.assert_close(
        verify_roofline.verify_leg("full", *ops, L),
        verify_batch.verify_packed3_ref(*ops, L), rtol=0, atol=0)
    with pytest.raises(ValueError, match="verify_roofline"):
        verify_cuda.verify_packed3(*ops, L, leg="gather")


def test_verify_work_on_hand_counted_inputs():
    """A plane of 40 words, 3 reads of 25 bases (3 words a row), 4
    candidates.  Least bytes: 4 * 4 words * 4 B of plane (under the
    plane's 160 B), 36 B of reads, 12 B of lengths, 4 * (4 + 1 + 4) B of
    candidate vectors, 16 B of counts.  Sectors of 8 words: the windows at
    words 0..3, 6..9, 13..16 and 36..39 touch 1, 2, 2 and 1; the rows at
    words 0..2, 3..5, 6..8 touch 1, 1 and 2, and the candidates name rows
    0, 2, 2, 1."""
    codes = np.zeros(400, np.int8)
    reads = np.zeros((3, 25), np.int8)
    ops = verify_operands(codes, [0, 60, 135, 369], reads, [0, 2, 2, 1],
                          [25, 25, 25], "cpu")
    work = verify_roofline.verify_work(*ops)
    vectors = 12 + 4 * 9 + 16
    assert work == {"candidates": 4, "words": 12,
                    "bytes": 64 + 36 + vectors,
                    "sector_bytes": 32 * (6 + 6) + vectors}
    # many candidates on a small plane: the plane counts once
    many = verify_operands(codes, np.arange(300), reads, np.zeros(300, int),
                           [25, 25, 25], "cpu")
    assert verify_roofline.verify_work(*many)["bytes"] == \
        160 + 36 + 12 + 300 * 13
    # 12 words * 11 operations / 32 lanes at 2 ns a warp instruction
    assert verify_roofline.verify_ops_ms(12, 2.0) == \
        pytest.approx(12 * 11 / 32 * 2.0 / 1e6, rel=1e-12)


def test_genome_case_plants_what_the_plain_version_counts():
    """The device-made case at a small size on the CPU: sorted by (read,
    position), every source window gets its planted mismatches, the other
    windows are random (about 3/4 of the bases differ)."""
    ops, is_source, planted = verify_genome_case(
        "cpu", seed=5, n_bases=60_000, n_reads=96, read_len=100, per_read=8)
    ref3, w10, l10, reads3, ridx, lens = ops
    assert ref3.shape == (6000,) and reads3.shape == (96, 10)
    assert l10.dtype == torch.uint8 and int(ref3.max()) < 1 << 30
    starts = (w10.long() * 10 + l10.long()).view(96, 8)
    assert (starts.diff(dim=1) >= 0).all() and (ridx.diff() >= 0).all()
    assert int(is_source.sum()) >= 96
    counts = verify_cuda.verify_packed3(*ops, 100)
    assert torch.equal(counts[is_source].long(), planted[ridx.long()[is_source]])
    assert set(planted.tolist()) == {0, 1, 2, 3}
    assert int(counts[~is_source].min()) > 40
    again, _, _ = verify_genome_case("cpu", seed=5, n_bases=60_000,
                                     n_reads=96)
    assert all(torch.equal(a, b) for a, b in zip(ops, again))
