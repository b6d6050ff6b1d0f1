"""What the tie-column kernel (``csrc/split_dp.cu::tie_kernel``) rests on,
held on the CPU, and the one tie-column call of ``realign_candidates``.

The kernel's group code (``csrc/tie_rows.cuh``: the row step, each lane's
min and bits at a captured row kept in a shared slot, the reduction and
the writes after the loop, passes of S slots) is built here for the host
(``csrc/tie_host.cpp``, with the host's C++ compiler, into ``build/``), one
thread playing a group's lanes and the warp's plan taken over its groups
as the card takes it.  It runs at every group shape of ``split_dp.cu``
whose columns hold the flank, with 32 slots a pass (the launch's cap) and
every row selection in shared memory, then with 3 and 1 slots (several
passes) and 2 and 0 selections in shared memory (the rest read from
``row_sel``), against the JAX ``dp_tie_columns``; on the cases whose
1,024-column reads take the JAX scan a minute to trace, against the port's
plain version, which ``tests/test_torch_tie_columns.py`` holds to the JAX
one.  Tolerance: none; the anchored maxima are equal integers and the
packed words equal bit for bit.

``realign_candidates`` now hands both sides of its winners (flank 1 with
the read, the reversed flank 2 with the reversed read) to one
``dp_tie_columns_cuda`` call, where the JAX package makes two; its split
rows and its {(candidate, row): columns} maps must equal the JAX
package's exactly.  The card's own build is held to the plain version on
the card by ``tests/test_torch_split_dp_cuda.py``.
"""

import ctypes
import functools
import hashlib
import os
import pathlib
import shutil
import subprocess
import types

import numpy as np
import pytest
import torch

from defuse_tpu.align import batch_realign as jax_realign
from defuse_tpu.ops import split_dp_batch as jax_dp
from defuse_tpu_torch.align import batch_realign as port_realign
from defuse_tpu_torch.align.split_dp import MIN_SPLIT_SCORE
from defuse_tpu_torch.ops import _build, split_dp_cuda
from defuse_tpu_torch.ops import split_dp_batch as port_dp

from torch_cases import (EDGE_CASES, SWEEP, edge_case, sweep_inputs,
                         tensors, tie_boundary_case, tie_rows)

CSRC = pathlib.Path(split_dp_cuda.__file__).resolve().parent.parent / "csrc"
HOST_FLAGS = ("-std=c++17", "-O2", "-shared", "-fPIC")
SHAPES = ((8, 16), (16, 18), (32, 16), (32, 32))  # split_dp.cu's FOR_SHAPES
# (slots a pass, selections a half in shared memory): the launch's choice
# for M <= 64, then several passes, and selections read from row_sel
PLANS = ((32, None), (3, 2), (1, 0))
SENTINEL = 0x5A5A5A5A  # an entry the kernel left unwritten keeps it
SLOW = {n for n in EDGE_CASES if n.startswith("L1024")}


@pytest.fixture(scope="module")
def host_lib():
    """The kernel's group code built for the host (``csrc/tie_host.cpp``).
    Skips where no C++ compiler is found."""
    cxx = shutil.which("g++") or shutil.which("c++")
    if cxx is None:
        pytest.skip("no host C++ compiler")
    src = CSRC / "tie_host.cpp"
    digest = hashlib.sha256(src.read_bytes() +
                            (CSRC / "tie_rows.cuh").read_bytes() +
                            " ".join(HOST_FLAGS).encode()).hexdigest()
    out = _build.BUILD_DIR.parent / "tie_host" / \
        f"libtie_host-{digest[:16]}.so"
    if not out.exists():
        out.parent.mkdir(parents=True, exist_ok=True)
        tmp = out.with_name(f"{out.name}.{os.getpid()}.tmp")
        subprocess.run([cxx, *HOST_FLAGS, "-o", str(tmp), str(src)],
                       check=True, capture_output=True)
        tmp.replace(out)
    lib = ctypes.CDLL(str(out))
    P, I = ctypes.c_void_p, ctypes.c_int
    lib.tie_columns_host.argtypes = [P, P, I, P, I, P, I, P, P, I, I, I, I,
                                     I, I]
    lib.tie_columns_host.restype = I
    return lib


def host_tie(lib, arrays, lanes, cmax, slots, selections):
    """(rowmax, packed) of the kernel's code on the host for (refs,
    ref_lens, reads, read_lens, row_sel), ``selections`` of each half's
    row selections kept in shared memory (the launch keeps min(M, 64))."""
    refs, ref_lens, reads, _read_lens, sel = (np.ascontiguousarray(a)
                                              for a in arrays)
    B, R = refs.shape
    L, M = reads.shape[1], sel.shape[1]
    ref_lens, sel = ref_lens.astype(np.int32), sel.astype(np.int32)
    rowmax = np.full((B, M), SENTINEL, np.int32)
    packed = np.full((B, M, (R + 32) // 32), SENTINEL, np.int32)
    assert lib.tie_columns_host(
        refs.ctypes.data, ref_lens.ctypes.data, R, reads.ctypes.data, L,
        sel.ctypes.data, M, rowmax.ctypes.data, packed.ctypes.data, B,
        MIN_SPLIT_SCORE, lanes, cmax, slots, selections) == 0
    return rowmax, packed


def case_arrays(name):
    """(refs, ref_lens, reads, read_lens, row_sel) of a sweep shape, an
    edge case or the word-boundary case, with every edge row selected."""
    if name == "boundary":
        arrays = tie_boundary_case()
    elif name.startswith("sweep"):
        arrays = sweep_inputs(*map(int, name[5:].split("x")))
    else:
        arrays, _screen = edge_case(name)
    L = arrays[2].shape[1]
    return (*arrays, tie_rows(arrays[3], L, 7, seed=L + len(arrays[1])))


CASES = ([f"sweep{R}x{L}" for R, L in SWEEP] + sorted(EDGE_CASES)
         + ["boundary"])
PARAMS = [(name, lanes, cmax) for name in CASES
          for lanes, cmax in SHAPES
          if lanes * cmax >= case_arrays(name)[0].shape[1] + 1]


@functools.lru_cache(maxsize=None)
def wanted(name):
    """The reference's (rowmax, packed) for a case: the JAX version's, or
    for the 1,024-column reads the port's plain version's."""
    arrays = case_arrays(name)
    if name in SLOW:
        got = port_dp.dp_tie_columns(*tensors(*arrays))
        return tuple(t.numpy() for t in got)
    rowmax, packed = jax_dp.dp_tie_columns(*arrays)
    return np.asarray(rowmax), np.asarray(packed).view(np.int32)


@pytest.mark.parametrize("name,lanes,cmax", PARAMS)
def test_kernel_code_matches_jax(host_lib, name, lanes, cmax):
    want_max, want_packed = wanted(name)
    arrays = case_arrays(name)
    for slots, selections in PLANS:
        selections = arrays[4].shape[1] if selections is None else selections
        got_max, got_packed = host_tie(host_lib, arrays, lanes, cmax, slots,
                                       selections)
        np.testing.assert_array_equal(got_max, want_max, err_msg=str(slots))
        assert got_packed.tobytes() == want_packed.tobytes(), slots


@pytest.mark.parametrize("lanes,cmax",
                         [s for s in SHAPES if s[0] * s[1] > 200])
def test_kernel_code_with_many_rows(host_lib, lanes, cmax):
    """40 rows an instance, duplicates and edges among them: a group's two
    halves capture most rows of a 64-row read, more than the launch's 32
    slots, so it runs the DP twice."""
    arrays = sweep_inputs(200, 64, seed=3, B=24)
    sel = tie_rows(arrays[3], 64, 40, seed=9)
    want_max, want_packed = jax_dp.dp_tie_columns(*arrays, sel)
    for slots, selections in ((32, 40), (7, 11)):
        got_max, got_packed = host_tie(host_lib, (*arrays, sel), lanes, cmax,
                                       slots, selections)
        np.testing.assert_array_equal(got_max, np.asarray(want_max))
        assert got_packed.tobytes() == np.asarray(want_packed).tobytes()
    assert len(set(sel[0]) | set(sel[1])) > 32


def rand_seq(rng, n):
    return "".join(rng.choice(list("ACGT"), n))


def sides_of(seed, n=9):
    """Two sides of ``n`` winners as ``realign_candidates`` builds them:
    (refs, reads, wanted rows, ref lengths) of flank 1 with the read and of
    the reversed flank 2 with the reversed read."""
    rng = np.random.default_rng(seed)
    ref1s, ref2s, reads, ks = [], [], [], []
    for b in range(n):
        r1 = rand_seq(rng, int(rng.integers(30, 120)))
        r2 = rand_seq(rng, int(rng.integers(30, 120)))
        ln = int(rng.integers(20, 60))
        a = int(rng.integers(1, ln))
        read = (r1[-a:] + r2[:ln - a])[:ln] if b % 3 else rand_seq(rng, ln)
        ref1s.append(r1)
        ref2s.append(r2)
        reads.append(read)
        a = min(a, len(read))
        ks.append(sorted({len(read) // 2, a, len(read)} if b % 2 else {a}))
    side1 = ([r for r in ref1s], reads, ks,
             np.array([len(r) for r in ref1s], np.int32))
    side2 = ([r[::-1] for r in ref2s], [r[::-1] for r in reads],
             [sorted({len(r) - k for k in rows})
              for r, rows in zip(reads, ks)],
             np.array([len(r) for r in ref2s], np.int32))
    return side1, side2


@pytest.fixture
def tie_calls(monkeypatch):
    """The calls ``_device_tie_columns`` makes of ``dp_tie_columns_cuda``
    (which it imports when it runs)."""
    calls = []
    real = split_dp_cuda.dp_tie_columns_cuda
    monkeypatch.setattr(split_dp_cuda, "dp_tie_columns_cuda",
                        lambda *ops: calls.append(ops) or real(*ops))
    split_dp_cuda.reset_launches()
    yield calls
    assert split_dp_cuda.LAUNCHES["split_dp_tie_columns"] == 0


@pytest.mark.parametrize("seed", [3, 4, 5])
def test_one_call_for_both_sides_matches_jax_two(seed, tie_calls):
    """Both sides in one call: each side's {(candidate, row): columns} map
    equals the JAX package's own call for that side."""
    sides = sides_of(seed)
    win_idx = [10 + b for b in range(len(sides[0][0]))]
    max_rows = max(len(rows) for side in sides for rows in side[2])
    want = [jax_realign._device_tie_columns(*side[:3], win_idx, 128,
                                            max_rows, side[3])
            for side in sides]
    got = port_realign._device_tie_columns(sides, win_idx, 128, max_rows,
                                           device="cpu")
    assert got == want
    assert len(tie_calls) == 1 and tie_calls[0][0].shape[0] == 2 * len(
        win_idx)
    assert any(v for m in want for v in m.values())
    assert not all(v for m in want for v in m.values())


def realign_inputs(pkg, seed, n_clusters=4, n_reads=40):
    """A realigner of ``n_clusters`` tasks (its flank pairs) and candidate
    reads against them, half of them junction reads, as ``pkg``'s
    ``Candidate``s."""
    rng = np.random.default_rng(seed)
    tasks = {}
    for c in range(n_clusters):
        # a run of G at both flanks' junction ends, once in a junction
        # read: its splits inside the run tie
        pair = (rand_seq(rng, int(rng.integers(150, 200))) + "GGGG",
                "GGGG" + rand_seq(rng, int(rng.integers(150, 200))))
        tasks[c] = types.SimpleNamespace(split_align_seq=pair)
    candidates = []
    for i in range(n_reads):
        c = int(rng.integers(0, n_clusters))
        r1, r2 = tasks[c].split_align_seq
        ln = int(rng.integers(40, 51))
        if i % 2:
            a = int(rng.integers(12, ln - 12))
            read = r1[len(r1) - a:] + r2[4:4 + ln - a]
        else:
            read = rand_seq(rng, ln)
        candidates.append(pkg.Candidate(i, c, 100 + i, i % 2, i % 3 == 0,
                                        read))
    return types.SimpleNamespace(tasks=tasks), candidates


def port_rowmax(*arrays):
    return port_dp.dp_row_maxima(*tensors(*arrays)).numpy()


@pytest.mark.parametrize("seed", [1, 2])
def test_realign_candidates_rows_match_jax(seed, tie_calls):
    """``realign_candidates`` without the native enumeration: one tie call
    for both sides, and the JAX package's split rows, in its order."""
    realigner, cands = realign_inputs(jax_realign, seed)
    want = jax_realign.realign_candidates(realigner, cands,
                                          jax_dp.dp_row_maxima)
    realigner, cands = realign_inputs(port_realign, seed)
    got = port_realign.realign_candidates(realigner, cands, port_rowmax,
                                          device="cpu")
    assert [r.format() for r in got] == [r.format() for r in want]
    assert len(want) > len({(r.fragment, r.read_end) for r in want}), \
        "no read with tied splits: the case checks nothing"
    assert len(tie_calls) == 1
