"""The batched EM kernel (``csrc/em.cu``, ``em_rows_kernel``) against its
plain PyTorch loop on the card.  Skips where CUDA is absent.  Imports no
``jax``, so it also runs on a machine without it:

    python -m pytest --noconftest -p no:cacheprovider \\
        tests/test_torch_em_cuda.py

Tolerances, stated once:

* float64, on rows where the kernel and the plain loop set the same ``ok``
  and finished at the same iteration: ``a`` and ``b`` within ``AB_TOL =
  1e-4`` bases, absolute (genome coordinates), ``ll`` within ``LL_RTOL =
  1e-9`` of ``max(1, |ll|)``; both sum in other orders, nothing else
  differs;
* float32: only the decisions: memberships (with the exact re-solve), and
  ``ok`` on rows that finished at the same iteration;
* memberships equal the exact answer (``native.em_cluster_batch``, or the
  oracle where the native library is not built) instance for instance;
* bits: two runs, whole or bucketed, in slabs or segments, at any padded
  width (also past shared memory), are the same bits (tolerance 0);
* the kernel's two M-steps on the card (``em_cuda.m_step_check``: the
  sequential walk and the warp form the kernel runs), on the same
  responsibilities: the same bits of ``a``, ``b`` and ``nk`` (tolerance
  0), on ``tests/test_torch_em_kernel.py``'s edge cases and on batches
  after 1, 5 and 20 iterations of the kernel.
"""

import dataclasses

import numpy as np
import pytest
import torch

from defuse_tpu_torch.cluster import matepair_em_batch as em
from defuse_tpu_torch.cluster import native
from defuse_tpu_torch.cluster.matepair_em import EMParams, MatePairEM
from defuse_tpu_torch.ops import em_cuda

from test_torch_em_kernel import M_STEP_EDGES, edge_batch
from torch_cases import em_instance

PARAMS = EMParams(fragment_mean=200.0, fragment_stddev=20.0,
                  precision=0.95, min_cluster_size=3)
SIGMA = PARAMS.fragment_stddev
AB_TOL, LL_RTOL = 1e-4, 1e-9
TINY = (np.array([100.0, 101.0, 102.0]), np.array([500.0, 501.0, 499.0]),
        np.array([100.0, 100.0, 100.0]))
OUTPUTS = ("a", "b", "w", "ll", "ok", "iters", "r", "done", "failed",
           "it_done")
DTYPES = {"float64": torch.float64, "float32": torch.float32}


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU")
    return torch.device("cuda")


def instances_of(seed, count):
    """Seeded bin pairs, the tiny one and one rounded to 20 bases."""
    rng = np.random.default_rng(seed)
    out = [em_instance(rng, rng.integers(1, 4), 24) for _ in range(count)]
    x, y, u = em_instance(rng, 2, 30)
    return out + [TINY, (np.round(x / 20) * 20, np.round(y / 20) * 20, u)]


def exact_sets(instances):
    if native.available():
        found = native.em_cluster_batch(instances, PARAMS)
    else:
        oracle = MatePairEM(PARAMS)
        found = [oracle.do_clustering(*inst) for inst in instances]
    return [[sorted(c) for c in clusters] for clusters in found]


def sets(memberships, n):
    return [[sorted(c) for c in memberships.get(i, [])] for i in range(n)]


def operands(batch, dtype, dev):
    return [torch.as_tensor(v, dtype=dtype, device=dev)
            for v in (batch.x, batch.y, batch.u)] + \
        [torch.as_tensor(batch.n, device=dev),
         torch.as_tensor(batch.k, device=dev),
         torch.as_tensor(batch.r0, dtype=dtype, device=dev)]


def both(batch, dtype, dev):
    """The kernel's and the plain loop's ten outputs, as numpy."""
    ops = operands(batch, dtype, dev)
    plain_runs = em.PLAIN_RUNS["cuda"]
    got = em.make_em_step(SIGMA)(*ops)
    assert em.PLAIN_RUNS["cuda"] == plain_runs
    ref = em._build_em_run_plain(SIGMA)(*ops)
    torch.cuda.synchronize()
    return ({k: np.asarray(v.cpu() if torch.is_tensor(v) else v)
             for k, v in zip(OUTPUTS, out)} for out in (got, ref))


@pytest.mark.cuda
@pytest.mark.parametrize("seed,count", [(0, 12), (7, 9), (21, 14)])
def test_kernel_matches_plain_float64(cuda_device, seed, count):
    instances = instances_of(seed, count)
    batch = em.prepare_batch(instances, PARAMS)
    launches = em_cuda.LAUNCHES["em_rows_kernel"]
    got, ref = both(batch, torch.float64, cuda_device)
    assert em_cuda.LAUNCHES["em_rows_kernel"] == launches + 1
    same = (got["it_done"] == ref["it_done"]) & (got["ok"] == ref["ok"])
    assert same.mean() >= 0.99, np.nonzero(~same)
    active = (np.arange(batch.r0.shape[1])[None, :] < batch.k[:, None]) \
        & same[:, None]
    for name in ("a", "b"):
        assert np.abs(got[name] - ref[name])[active].max() <= AB_TOL, name
    assert (np.abs(got["ll"] - ref["ll"]) <= LL_RTOL * np.maximum(
        1.0, np.abs(ref["ll"])))[same].all()
    assert got["ok"].sum() > len(batch.n) // 2
    memberships = em.run_batch(batch, PARAMS, device=cuda_device)
    assert sets(memberships, len(instances)) == exact_sets(instances)


@pytest.mark.cuda
@pytest.mark.parametrize("seed,count", [(0, 12), (21, 14)])
def test_kernel_float32_decisions(cuda_device, seed, count):
    instances = instances_of(seed, count)
    batch = em.prepare_batch(instances, PARAMS)
    got = em.run_em(batch, PARAMS, torch.float32, cuda_device)
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(em, "_build_em_run", em._build_em_run_plain)
        ref = em.run_em(batch, PARAMS, torch.float32, cuda_device)
    assert got[3].mean() > 0.5
    assert (got[3] == ref[3]).mean() >= 0.95
    memberships = em.run_batch(batch, PARAMS, dtype=np.float32,
                               device=cuda_device)
    assert sets(memberships, len(instances)) == exact_sets(instances)


@pytest.mark.cuda
@pytest.mark.parametrize("name", DTYPES)
def test_kernel_bits_across_runs_slabs_and_segments(cuda_device, name):
    """``run_em``'s four outputs are the same bits twice over, in one
    launch at the padded width, bucketed, and in slabs of three rows; the
    kernel launches once a slab and segment."""
    batch = em.prepare_batch(instances_of(5, 10), PARAMS)
    dtype = DTYPES[name]
    runs = []
    for chunk in (None, None, 0, 3):
        launches = em_cuda.LAUNCHES["em_rows_kernel"]
        runs.append(em.run_em(batch, PARAMS, dtype, cuda_device, chunk))
        expect = 1 if chunk == 0 else em.EM_RUN_STATS["slabs"]
        assert em_cuda.LAUNCHES["em_rows_kernel"] - launches == expect
    for other in runs[1:]:
        for want, got in zip(runs[0], other):
            assert want.dtype == got.dtype and want.tobytes() == \
                got.tobytes()


@pytest.mark.cuda
@pytest.mark.parametrize("name", DTYPES)
def test_kernel_bits_at_any_width_and_when_resumed(cuda_device, name):
    """A row's bits do not move when the batch is padded past what shared
    memory holds (the responsibilities in the carry, then the row's arrays
    in device scratch), nor when ``max_iters`` cuts the run and the carry
    resumes it."""
    dtype = DTYPES[name]
    batch = em.prepare_batch(instances_of(3, 4), PARAMS)
    whole = dict(zip(OUTPUTS, em.make_em_step(SIGMA)(
        *operands(batch, dtype, cuda_device))))
    B, KM, N = batch.r0.shape
    for width in (1200, 3000):
        pad = width - N
        wide = dataclasses.replace(
            batch, **{f: np.pad(getattr(batch, f), [(0, 0), (0, pad)])
                      for f in ("x", "y", "u")},
            r0=np.pad(batch.r0, [(0, 0), (0, 0), (0, pad)]))
        got = dict(zip(OUTPUTS, em.make_em_step(SIGMA)(
            *operands(wide, dtype, cuda_device))))
        for key in ("a", "b", "ll", "done", "failed", "it_done"):
            assert torch.equal(got[key], whole[key]), (width, key)
        assert torch.equal(got["r"][:, :, :N].nan_to_num(7.0),
                           whole["r"].nan_to_num(7.0))
    # segments as _run_bucketed cuts them: the rows still running resume
    # from their carry, the finished ones retire
    ops = operands(batch, dtype, cuda_device)
    run = em.make_em_step(SIGMA)
    out = {key: torch.zeros_like(whole[key]) for key in ("a", "b", "ll")}
    sel = torch.arange(B, device=cuda_device)
    r, ll, a, b = ops[5], None, None, None
    segments = 0
    while len(sel):
        a, b, _w, ll, _ok, _it, r, done, failed, _itd = run(
            *(t[sel] for t in ops[:5]), r, ll, max_iters=7, a0=a, b0=b)
        for key, v in (("a", a), ("b", b), ("ll", ll)):
            out[key][sel] = v
        keep = ~(done | failed)
        sel, r, ll, a, b = sel[keep], r[keep], ll[keep], a[keep], b[keep]
        segments += 1
    for key in out:
        assert torch.equal(out[key], whole[key]), key
    assert segments >= 2


@pytest.mark.cuda
@pytest.mark.parametrize("name", DTYPES)
def test_point_without_mass_fails_the_row(cuda_device, name):
    """``tests/test_torch_em_batch.py``'s row whose far point has no
    mixture mass: failed and not ok, as in the plain loop; in float32 its
    responsibilities are 0 over 0."""
    inst = (np.array([1000.0, 1001.0, 1002.0, -50.0]),
            np.array([2000.0, 2001.0, 2002.0, -50.0]), np.full(4, 100.0))
    batch = em.prepare_batch([inst], PARAMS)
    row = int(np.nonzero(batch.k == 2)[0][0])
    batch.r0[row] = 0.0
    batch.r0[row, 0, :4] = 1.0
    got, ref = both(batch, DTYPES[name], cuda_device)
    assert got["failed"][row] and not got["ok"][row]
    for key in ("ok", "done", "failed", "it_done"):
        np.testing.assert_array_equal(got[key], ref[key], key)
    np.testing.assert_array_equal(np.isnan(got["r"]), np.isnan(ref["r"]))
    assert np.isnan(got["r"][row]).any() == (name == "float32")


def forms_differ(got):
    """The components whose a, b or nk differ in a bit between the walk
    and the warp form."""
    out = []
    for walk, warp in zip(got["walk"], got["warp"]):
        p, q = (v.cpu().numpy() for v in (walk, warp))
        out.append((p.view(np.uint8).reshape(p.shape + (-1,))
                    != q.view(np.uint8).reshape(q.shape + (-1,))).any(-1))
    return np.logical_or.reduce(out)


@pytest.mark.cuda
@pytest.mark.parametrize("name", DTYPES)
@pytest.mark.parametrize("edge", M_STEP_EDGES)
def test_m_step_forms_same_bits_on_edges(cuda_device, edge, name):
    dtype = DTYPES[name]
    batch, r, a0, b0 = edge_batch(edge, np.random.default_rng(
        M_STEP_EDGES.index(edge)))
    ops = [torch.as_tensor(v, dtype=dtype, device=cuda_device)
           for v in (batch.x, batch.y, batch.u)] + \
        [torch.as_tensor(v, dtype=torch.int32, device=cuda_device)
         for v in (batch.n, batch.k)] + \
        [torch.as_tensor(v, dtype=dtype, device=cuda_device).contiguous()
         for v in (r, a0, b0)]
    got = em_cuda.m_step_check(*ops, sigma=SIGMA, lam=em.LAMBDA)
    assert not forms_differ(got).any(), np.nonzero(forms_differ(got))
    assert (got["walk"][2] > 0).sum() >= 4


@pytest.mark.cuda
@pytest.mark.parametrize("name", DTYPES)
@pytest.mark.parametrize("iters", [1, 5, 20])
def test_m_step_forms_same_bits_after_iterations(cuda_device, iters, name):
    """The responsibilities, a and b that ``iters`` iterations of the
    kernel leave, through both M-steps, also past shared memory (N
    3,000, the rows' arrays in device scratch)."""
    dtype = DTYPES[name]
    batch = em.prepare_batch(instances_of(7, 9), PARAMS)
    for width in (batch.x.shape[1], 3000):
        pad = width - batch.x.shape[1]
        wide = dataclasses.replace(
            batch, **{f: np.pad(getattr(batch, f), [(0, 0), (0, pad)])
                      for f in ("x", "y", "u")},
            r0=np.pad(batch.r0, [(0, 0), (0, 0), (0, pad)]))
        x, y, u, n, k, r = operands(wide, dtype, cuda_device)
        B, KM = r.shape[:2]
        r = torch.where(torch.arange(KM, device=cuda_device)[None, :, None]
                        < k[:, None, None], r, 0.0).contiguous()
        a = torch.zeros((B, KM), dtype=dtype, device=cuda_device)
        b = torch.zeros_like(a)
        ll = torch.full((B,), -float(em.BIG), dtype=dtype,
                        device=cuda_device)
        em_cuda.em_rows(x, y, u, n, k, r, a, b, ll, max_iters=iters,
                        never=em.MAX_ITERS + 1, sigma=SIGMA, lam=em.LAMBDA,
                        tol=em.TOLERANCE)
        got = em_cuda.m_step_check(x, y, u, n, k, r, a, b, sigma=SIGMA,
                                   lam=em.LAMBDA)
        assert not forms_differ(got).any(), (width, np.nonzero(
            forms_differ(got)))
        assert (got["walk"][2] > 0).sum() > B

