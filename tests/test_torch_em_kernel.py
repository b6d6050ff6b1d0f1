"""What the batched EM's kernel (``csrc/em.cu``) rests on, held on the CPU.

The kernel's row code (``csrc/em_row.cuh``) is built here for the host
(``csrc/em_host.cpp``, with the host's C++ compiler, into ``build/``) and
run on CPU tensors through the same Python as the card's launches
(``matepair_em_batch._em_run_rows``).  Tolerances, stated once:

* the M-step: the reference's sequential merge (``_EMState.max_likelihood``,
  which the kernel walks), the plain ``_m_step`` and the kernel's first
  iteration give the same ``(ok, a, b)``: exactly where every sum is dyadic
  (one-hot responsibilities, or uniform at K a power of 2), else within
  ``M_STEP_TOL = 1e-6`` bases, absolute (the sums add in other orders);
* the whole EM in float64, against the plain loop: on rows that finish at
  the same iteration with the same ``ok``, ``a`` and ``b`` within
  ``AB_TOL = 1e-4`` bases, absolute (genome coordinates: a relative bound
  would allow whole bases), ``ll`` within ``LL_RTOL = 1e-9`` of
  ``max(1, |ll|)``; memberships equal the oracle's exactly;
* bits: a row's outputs are the same bits whatever its batch, padding or
  segments (tolerance 0).

The card's own build is held to the plain loop on the card by
``tests/test_torch_em_cuda.py``.
"""

import ctypes
import dataclasses
import hashlib
import inspect
import os
import pathlib
import shutil
import subprocess

import numpy as np
import pytest
import torch

from defuse_tpu_torch.cluster import matepair_em_batch as em
from defuse_tpu_torch.cluster.matepair_em import (LAMBDA, TOLERANCE,
                                                  EMParams, MatePairEM,
                                                  _EMState)
from defuse_tpu_torch.ops import _build, em_cuda
from defuse_tpu_torch.utils import synth
from torch_cases import em_instance

PARAMS = EMParams(fragment_mean=200.0, fragment_stddev=20.0,
                  precision=0.95, min_cluster_size=3)
SIGMA = PARAMS.fragment_stddev
M_STEP_TOL, AB_TOL, LL_RTOL = 1e-6, 1e-4, 1e-9
TINY = (np.array([100.0, 101.0, 102.0]), np.array([500.0, 501.0, 499.0]),
        np.array([100.0, 100.0, 100.0]))
OUTPUTS = ("a", "b", "w", "ll", "ok", "iters", "r", "done", "failed",
           "it_done")
CSRC = pathlib.Path(em_cuda.__file__).resolve().parent.parent / "csrc"
HOST_FLAGS = ("-std=c++17", "-O2", "-ffp-contract=off", "-shared", "-fPIC")


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


@pytest.fixture(scope="module")
def host_rows():
    """``em_cuda.em_rows``'s counterpart on CPU tensors: the kernel's row
    code built for the host.  Skips where no C++ compiler is found."""
    cxx = shutil.which("g++") or shutil.which("c++")
    if cxx is None:
        pytest.skip("no host C++ compiler")
    src = CSRC / "em_host.cpp"
    digest = hashlib.sha256(src.read_bytes() +
                            (CSRC / "em_row.cuh").read_bytes() +
                            " ".join(HOST_FLAGS).encode()).hexdigest()
    out = _build.BUILD_DIR.parent / "em_host" / f"libem_host-{digest[:16]}.so"
    if not out.exists():
        out.parent.mkdir(parents=True, exist_ok=True)
        tmp = out.with_name(f"{out.name}.{os.getpid()}.tmp")
        subprocess.run([cxx, *HOST_FLAGS, "-o", str(tmp), str(src)],
                       check=True, capture_output=True)
        tmp.replace(out)
    lib = ctypes.CDLL(str(out))
    entry = {}
    for dtype, name in ((torch.float64, "em_rows_host_f64"),
                        (torch.float32, "em_rows_host_f32")):
        fn = getattr(lib, name)
        fn.argtypes = [ctypes.c_void_p] * 13 + [ctypes.c_int] * 5 + \
            [ctypes.c_double] * 3
        entry[dtype] = fn

    def rows(x, y, u, n, k, r, a, b, ll, *, max_iters, never, sigma, lam,
             tol):
        B, KM, N = r.shape
        for t in (x, y, u, n, k, r, a, b, ll):
            assert t.device.type == "cpu" and t.is_contiguous()
        assert n.dtype == k.dtype == torch.int32
        w = torch.zeros((B, KM), dtype=x.dtype)
        done, failed = (torch.zeros(B, dtype=torch.uint8) for _ in range(2))
        it_done = torch.full((B,), never, dtype=torch.int32)
        entry[x.dtype](*(t.data_ptr() for t in (x, y, u, n, k, r, a, b, w,
                                                 ll, done, failed, it_done)),
                       B, KM, N, max_iters, never, sigma, lam, tol)
        return w, done.bool(), failed.bool(), it_done
    return rows


def run_rows(rows, batch, dtype, **kw):
    """The ten outputs of ``em_run`` through ``rows`` on one batch."""
    return dict(zip(OUTPUTS, em._em_run_rows(
        rows, SIGMA, LAMBDA, TOLERANCE,
        *(torch.as_tensor(v, dtype=dtype) for v in (batch.x, batch.y,
                                                    batch.u)),
        torch.as_tensor(batch.n), torch.as_tensor(batch.k),
        torch.as_tensor(batch.r0, dtype=dtype), kw.get("ll0"),
        kw.get("max_iters", em.MAX_ITERS), kw.get("a0"), kw.get("b0"))))


def run_plain(batch, dtype):
    return dict(zip(OUTPUTS, em._build_em_run_plain(SIGMA)(
        *(torch.as_tensor(v, dtype=dtype) for v in (batch.x, batch.y,
                                                    batch.u)),
        torch.as_tensor(batch.n), torch.as_tensor(batch.k),
        torch.as_tensor(batch.r0, dtype=dtype))))


def em_run_through(rows):
    """A stand-in for ``_build_em_run`` whose every ``em_run`` goes
    through ``rows``, as CUDA tensors go through the kernel."""
    def build(sigma, lam=LAMBDA, tol=TOLERANCE, check_every=None):
        def em_run(x, y, u, n, k, r0, ll0=None, max_iters=em.MAX_ITERS,
                   a0=None, b0=None):
            return em._em_run_rows(rows, sigma, lam, tol, x, y, u, n, k, r0,
                                   ll0, max_iters, a0, b0)
        return em_run
    return build


def instances_of(seed, count, flat=False):
    """Seeded bin pairs, the tiny one and one rounded to 20 bases (runs of
    equal x and y); with ``flat``, last, the same pairs at a u far below
    any fragment's: the derivative of some components never turns
    positive, and the likelihood is flat over thousands of bases."""
    rng = np.random.default_rng(seed)
    out = [em_instance(rng, rng.integers(1, 4), 24) for _ in range(count)]
    x, y, u = em_instance(rng, 2, 30)
    out += [TINY, (np.round(x / 20) * 20, np.round(y / 20) * 20, u)]
    return out + [(x, y, u - 4000.0)] if flat else out


def oracle_sets(instances):
    oracle = MatePairEM(PARAMS)
    return [[sorted(c) for c in oracle.do_clustering(*inst)]
            for inst in instances]


def sets(memberships, n):
    return [[sorted(c) for c in memberships.get(i, [])] for i in range(n)]


def test_em_instance_is_the_jax_tests_instance():
    """The CUDA tests make their bin pairs with ``utils.synth.em_instance``
    (no ``jax``): it is ``tests/test_em_batch.py``'s ``_instance``."""
    import test_em_batch
    ref = inspect.getsource(test_em_batch._instance)
    assert inspect.getsource(synth.em_instance) == \
        ref.replace("def _instance(", "def em_instance(")


# --- (1) the M-step: the reference's merge, the plain version, the kernel ----

M_STEP_KINDS = ("onehot", "uniform", "fractional", "runs", "massless",
                "ties")


def m_step_case(kind, seed):
    """A padded batch of four bin pairs at every K and the
    responsibilities its M-step gets, and whether every sum is dyadic."""
    rng = np.random.default_rng(seed)
    instances = [em_instance(rng, rng.integers(1, 4), 24) for _ in range(4)]
    if kind == "runs":  # many points share an x or a y
        instances = [(np.round(x / 20) * 20, np.round(y / 20) * 20, u)
                     for x, y, u in instances]
    if kind == "ties":  # one order on both sides: equal sums at every run
        instances = [(x, x + 500.0, u) for x, _y, u in instances]
    batch = em.prepare_batch(instances + [TINY], PARAMS)
    B, KM, N = batch.r0.shape
    active = np.arange(KM)[None, :, None] < batch.k[:, None, None]
    if kind == "onehot":
        pick = rng.integers(0, batch.k[:, None], (B, N))
        r = (np.arange(KM)[None, :, None] == pick[:, None, :]) * 1.0
    elif kind == "uniform":
        r = np.ones((B, KM, N)) / batch.k[:, None, None]
    else:
        r = rng.random((B, KM, N))
    r = r * active
    if kind == "massless":  # the first component has no mass at K >= 2
        r[batch.k >= 2, 0] = 0.0
    if kind not in ("onehot", "uniform"):
        r = r / np.maximum(r.sum(axis=1, keepdims=True), 1e-300)
    dyadic = kind == "onehot" or (kind == "uniform" and all(
        k & (k - 1) == 0 for k in batch.k))
    return batch, r, dyadic


def oracle_m_step(x, y, u, r):
    """``_EMState.max_likelihood`` of each component row of ``r``."""
    xo, yo = np.argsort(-x, kind="stable"), np.argsort(-y, kind="stable")
    state = _EMState(MatePairEM(PARAMS), x, y, u, x[xo], y[yo], None, None)
    return [state.max_likelihood(rj, rj[xo], rj[yo]) for rj in r]


@pytest.mark.parametrize("seed", [0, 1])
@pytest.mark.parametrize("kind", M_STEP_KINDS)
def test_m_step_merge_matches_plain(host_rows, kind, seed):
    """The reference's sequential merge and the kernel's first M-step
    against the plain ``_m_step``, component by component."""
    batch, r, dyadic = m_step_case(kind, seed)
    x, y, u = (torch.as_tensor(v) for v in (batch.x, batch.y, batch.u))
    n = torch.as_tensor(batch.n)
    point_valid = torch.arange(x.shape[1])[None, :] < n[:, None]
    a, b, ok = (t.numpy() for t in em._m_step(
        torch.as_tensor(r), em._batch_static(x, y, u, point_valid), SIGMA,
        LAMBDA))
    got = run_rows(host_rows, dataclasses.replace(batch, r0=r),
                   torch.float64, max_iters=1)
    tol = 0.0 if dyadic else M_STEP_TOL
    compared = 0
    for row in range(len(batch.n)):
        nn, kk = int(batch.n[row]), int(batch.k[row])
        oracle = oracle_m_step(batch.x[row, :nn], batch.y[row, :nn],
                               batch.u[row, :nn], r[row, :kk, :nn])
        for j, (o_ok, o_a, o_b) in enumerate(oracle):
            assert o_ok == ok[row, j], (row, j)
            if not o_ok:
                assert got["a"][row, j] == 0 and got["b"][row, j] == 0
                continue
            compared += 1
            for want, mine in ((a[row, j], o_a), (b[row, j], o_b),
                               (a[row, j], got["a"][row, j].item()),
                               (b[row, j], got["b"][row, j].item())):
                assert abs(mine - want) <= tol, (kind, row, j, mine, want)
    assert compared > 20
    if kind == "massless":
        assert not ok[batch.k >= 2, 0].any()


def test_m_step_without_rising_entry_takes_the_path_end(host_rows):
    """Where the likelihood's derivative never turns positive (u far below
    the spread of x + y), the plain version and the kernel take the merge
    path's last entry as the breakpoint, a corner of the points' x and y;
    the reference reads past its vector there, and the oracle's guard may
    take the middle of the last flat stretch instead."""
    rng = np.random.default_rng(3)
    x, y, u = em_instance(rng, 1, 24)
    u = u - 4000.0
    batch = em.prepare_batch([(x, y, u)], PARAMS)
    B, KM, N = batch.r0.shape
    pick = rng.integers(0, batch.k[:, None], (B, N))
    r = (np.arange(KM)[None, :, None] == pick[:, None, :]) * 1.0
    r = r * (np.arange(KM)[None, :, None] < batch.k[:, None, None])
    # the derivative's bound at the path's end, where it is largest
    nk = r.sum(axis=2)
    rising = ((r * (x + y + u)).sum(axis=2) - nk * (x.min() + y.min())) \
        / SIGMA ** 2 + LAMBDA * nk
    xt, yt, ut = (torch.as_tensor(v) for v in (batch.x, batch.y, batch.u))
    a, b, ok = (t.numpy() for t in em._m_step(
        torch.as_tensor(r), em._batch_static(
            xt, yt, ut, torch.ones(xt.shape, dtype=torch.bool)), SIGMA,
        LAMBDA))
    got = run_rows(host_rows, dataclasses.replace(batch, r0=r),
                   torch.float64, max_iters=1)
    mask = ok & (np.arange(KM)[None, :] < batch.k[:, None])
    assert mask.sum() > 10 and (rising[mask] < 0).all()
    assert np.isin(a[mask], x).all() and np.isin(b[mask], y).all()
    np.testing.assert_array_equal(got["a"].numpy()[mask], a[mask])
    np.testing.assert_array_equal(got["b"].numpy()[mask], b[mask])


# --- (2) the whole EM: the kernel's row code against the plain loop ---------

@pytest.mark.parametrize("seed,count", [(0, 12), (7, 9), (21, 14)])
def test_kernel_em_matches_plain_float64(host_rows, seed, count):
    """On the flat bin pair (``instances_of``'s last) the breakpoints of
    components with almost no mass move by thousands of bases between any
    two summation orders, the JAX program's and the plain loop's too, at
    log-likelihoods equal to 1e-15: there only ``ll`` and the flags are
    held."""
    batch = em.prepare_batch(instances_of(seed, count, flat=True), PARAMS)
    flat = batch.instance == batch.instance.max()
    got = run_rows(host_rows, batch, torch.float64)
    ref = run_plain(batch, torch.float64)
    got, ref = ({k: np.asarray(v) for k, v in d.items()} for d in (got, ref))
    same = (got["it_done"] == ref["it_done"]) & (got["ok"] == ref["ok"])
    assert same.mean() >= 0.99, np.nonzero(~same)
    active = (np.arange(batch.r0.shape[1])[None, :] < batch.k[:, None]) \
        & (same & ~flat)[:, None]
    for name in ("a", "b"):
        assert np.abs(got[name] - ref[name])[active].max() <= AB_TOL, name
    assert (np.abs(got["ll"] - ref["ll"]) <= LL_RTOL * np.maximum(
        1.0, np.abs(ref["ll"])))[same].all()
    np.testing.assert_array_equal(got["failed"][same], ref["failed"][same])
    assert got["ok"].sum() > len(batch.n) // 2
    if same.all():
        assert got["iters"] == ref["iters"]
    assert got["a"].dtype == np.float64 and got["it_done"].dtype == np.int32


@pytest.mark.parametrize("kw", [
    dict(), dict(chunk_rows=0), dict(chunk_rows=7),
    dict(dtype=np.float32), dict(dtype=np.float32, chunk_rows=0)],
    ids=["bucketed", "one-launch", "slabs-of-7", "f32-resolve",
         "f32-one-launch"])
def test_kernel_run_batch_matches_oracle(host_rows, monkeypatch, kw):
    """``run_batch`` with every ``em_run`` through the kernel's row code:
    the memberships of the exact oracle, instance for instance (float32
    with the exact re-solve of the instances inside its margins)."""
    monkeypatch.setattr(em, "_build_em_run", em_run_through(host_rows))
    plain_runs = dict(em.PLAIN_RUNS)
    instances = instances_of(0, 12)
    got = em.run_batch(em.prepare_batch(instances, PARAMS), PARAMS,
                       device="cpu", **kw)
    assert sets(got, len(instances)) == oracle_sets(instances)
    assert em.PLAIN_RUNS == plain_runs


@pytest.mark.parametrize("dtype", [torch.float64, torch.float32])
def test_kernel_bits_depend_only_on_the_row(host_rows, dtype):
    """A row's a, b, ll, flags and responsibilities are the same bits run
    with the whole batch, in a slab of other rows, padded wider (N and K),
    and resumed in segments of five iterations."""
    batch = em.prepare_batch(instances_of(5, 8), PARAMS)
    whole = run_rows(host_rows, batch, dtype)
    B, KM, N = batch.r0.shape
    rows = np.arange(B)[::-3].copy()
    sub = dataclasses.replace(batch, **{f: getattr(batch, f)[rows] for f in (
        "x", "y", "u", "n", "k", "r0")})
    wide = dataclasses.replace(
        batch, **{f: np.pad(getattr(batch, f), [(0, 0), (0, 17)])
                  for f in ("x", "y", "u")},
        r0=np.pad(batch.r0, [(0, 0), (0, 2), (0, 17)]))

    def same(got, at, kk, nn):
        for name in ("a", "b"):
            assert torch.equal(got[name][:, :kk], whole[name][at, :kk]), name
        for name in ("ll", "done", "failed"):
            assert torch.equal(got[name], whole[name][at]), name
        assert torch.equal(got["r"][:, :kk, :nn].nan_to_num(7.0),
                           whole["r"][at, :kk, :nn].nan_to_num(7.0))

    same(run_rows(host_rows, sub, dtype), rows, KM, N)
    same(run_rows(host_rows, wide, dtype), np.arange(B), KM, N)
    assert torch.equal(run_rows(host_rows, wide, dtype)["it_done"],
                       whole["it_done"])
    # segments as _run_bucketed cuts them: the rows still running resume
    # from their carry, the finished ones retire
    out = {name: whole[name].clone() for name in ("a", "b", "ll", "r")}
    alive = np.arange(B)
    part = dataclasses.replace(batch)
    carry = {}
    while len(alive):
        seg = run_rows(host_rows, part, dtype, max_iters=5, **carry)
        for name in out:
            out[name][alive] = seg[name]
        fin = (seg["done"] | seg["failed"]).numpy()
        assert torch.equal(seg["done"][fin], whole["done"][alive[fin]])
        keep = ~fin
        alive = alive[keep]
        part = dataclasses.replace(
            part, **{f: getattr(part, f)[keep] for f in ("x", "y", "u", "n",
                                                         "k")},
            r0=seg["r"][keep].numpy())
        carry = dict(ll0=seg["ll"][keep], a0=seg["a"][keep],
                     b0=seg["b"][keep])
    for name in ("a", "b", "ll"):
        assert torch.equal(out[name], whole[name]), name
    assert torch.equal(out["r"].nan_to_num(7.0), whole["r"].nan_to_num(7.0))


def massless_batch():
    """``tests/test_torch_em_batch.py``'s row whose far point has no
    mixture mass at K = 2."""
    inst = (np.array([1000.0, 1001.0, 1002.0, -50.0]),
            np.array([2000.0, 2001.0, 2002.0, -50.0]), np.full(4, 100.0))
    batch = em.prepare_batch([inst], PARAMS)
    row = int(np.nonzero(batch.k == 2)[0][0])
    batch.r0[row] = 0.0
    batch.r0[row, 0, :4] = 1.0
    return batch, row


@pytest.mark.parametrize("dtype", [torch.float64, torch.float32])
def test_point_without_mass_fails_the_row(host_rows, dtype):
    """The kernel marks the row failed as the plain loop does; in float32
    its responsibilities are 0 over 0 (the divisor floor rounds to 0)."""
    batch, row = massless_batch()
    got = run_rows(host_rows, batch, dtype)
    ref = run_plain(batch, dtype)
    assert got["failed"][row] and not got["ok"][row]
    for name in ("ok", "done", "failed", "it_done"):
        assert torch.equal(got[name], ref[name]), name
    assert torch.equal(got["r"].isnan(), ref["r"].isnan())
    assert bool(got["r"][row].isnan().any()) == (dtype == torch.float32)


# --- (3) the wrapper ----------------------------------------------------------

def test_cpu_tensors_never_bind_the_kernel(monkeypatch):
    """``run_batch(device="cpu")`` runs the plain loop and never builds or
    loads ``em.cu``, bucketed or in one launch."""
    def refuse(*_a, **_k):
        raise AssertionError("the EM kernel was bound for CPU tensors")
    monkeypatch.setattr(_build, "bind", refuse)
    monkeypatch.setattr(_build, "load", refuse)
    batch = em.prepare_batch(instances_of(1, 3), PARAMS)
    before = em.PLAIN_RUNS["cpu"]
    launches = em_cuda.LAUNCHES["em_rows_kernel"]
    for chunk in (None, 0):
        assert em.run_batch(batch, PARAMS, device="cpu", chunk_rows=chunk)
    assert em.PLAIN_RUNS["cpu"] > before
    assert em_cuda.LAUNCHES["em_rows_kernel"] == launches


def test_non_cpu_tensors_never_take_the_plain_version():
    """A tensor that is not on the CPU goes to the kernel's wrapper, which
    takes only CUDA tensors: the plain loop never runs for it, and CPU
    tensors handed to the wrapper are refused too."""
    batch = em.prepare_batch(instances_of(2, 2), PARAMS)
    before = dict(em.PLAIN_RUNS)
    for device in ("meta", "cpu"):
        ops = [torch.as_tensor(v, dtype=torch.float64).to(device)
               for v in (batch.x, batch.y, batch.u)] + \
            [torch.as_tensor(batch.n).to(device),
             torch.as_tensor(batch.k).to(device),
             torch.as_tensor(batch.r0, dtype=torch.float64).to(device)]
        with pytest.raises(ValueError, match="CUDA"):
            if device == "meta":
                em.make_em_step(SIGMA)(*ops)
            else:
                em._em_run_rows(em_cuda.em_rows, SIGMA, LAMBDA, TOLERANCE,
                                *ops, None, 5, None, None)
    assert em.PLAIN_RUNS == before


def test_failed_em_build_raises_with_nvcc_stderr(tmp_path, monkeypatch):
    fake = tmp_path / "nvcc"
    fake.write_text("#!/bin/sh\necho 'em.cu(1): error: no such type' >&2\n"
                    "exit 2\n")
    fake.chmod(0o755)
    monkeypatch.setattr(_build, "find_nvcc", lambda: str(fake))
    monkeypatch.setattr(_build, "BUILD_DIR", tmp_path / "kernels")
    monkeypatch.setattr(_build, "_LOADED", {})
    monkeypatch.setattr(_build, "_BOUND", {})
    with pytest.raises(RuntimeError, match="no such type") as err:
        em_cuda._lib()
    assert "nvcc failed building em (exit 2)" in str(err.value)


def test_em_build_hashes_its_header_and_flags(tmp_path, monkeypatch):
    """``em.cu`` is built with ``--fmad=false`` and rebuilt when
    ``em_row.cuh`` changes; the other sources keep their flags."""
    assert "--fmad=false" in _build.flags("em")
    assert "--fmad=false" not in _build.flags("split_dp")
    csrc = tmp_path / "csrc"
    shutil.copytree(CSRC, csrc)
    monkeypatch.setattr(_build, "CSRC", csrc)
    before = _build.library_path("em")
    (csrc / "em_row.cuh").write_text((csrc / "em_row.cuh").read_text() + "\n")
    assert _build.library_path("em") != before


def test_run_batch_on_cuda_without_a_card_raises():
    if torch.cuda.is_available():
        pytest.skip("CUDA is available here")
    batch = em.prepare_batch(instances_of(0, 2), PARAMS)
    with pytest.raises(RuntimeError, match="is_available"):
        em.run_batch(batch, PARAMS, device="cuda")
