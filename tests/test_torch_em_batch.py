"""The port's batched mate-pair EM against ``defuse_tpu``'s on the CPU.

The same instances, made from a numpy seed, go through the JAX program
(x64 on, as ``conftest.py`` sets it) and through the PyTorch program on CPU
tensors.  Tolerances, stated once:

* float64, ``em_run`` and ``_m_step``: ``a``, ``b``, ``w``, ``ll`` within
  ``RTOL64 = 1e-9`` relative (absolute below 1); the flags and the
  iteration counts equal.  Both sum in another order, nothing else differs.
* float32: a row stops where ``|Δll| < 1e-3`` on log-likelihoods whose own
  rounding is ~3e-5, so some rows stop an iteration or two apart in the two
  programs, and a few leave a plateau tens of iterations apart and end in
  another optimum (the JAX float32 program is as far from its own float64
  run).  Rows that stop at the same iteration agree within
  ``RTOL32 = 1e-4`` on ``ll``, and at least ``1 - F32_OUTLIERS = 97%`` of
  all rows do.
* ``run_batch``: memberships equal, instance for instance, those of the JAX
  ``run_batch`` and of the exact oracle ``MatePairEM`` (no tolerance; the
  reference's own test allows one disagreement in 13, this one none on
  these seeds).
"""

import unittest.mock as um

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from defuse_tpu.cluster import matepair_em_batch as jax_em
from defuse_tpu_torch.cluster import matepair_em_batch as port_em
from defuse_tpu_torch.cluster import native
from defuse_tpu_torch.cluster.matepair_em import (LAMBDA, EMParams,
                                                  MatePairEM)

from test_em_batch import PARAMS as JAX_PARAMS
from test_em_batch import _instance

PARAMS = EMParams(fragment_mean=200.0, fragment_stddev=20.0,
                  precision=0.95, min_cluster_size=3)
SIGMA = PARAMS.fragment_stddev
RTOL64, RTOL32, F32_OUTLIERS = 1e-9, 1e-4, 0.03
TINY = (np.array([100.0, 101.0, 102.0]), np.array([500.0, 501.0, 499.0]),
        np.array([100.0, 100.0, 100.0]))
OUTPUTS = ("a", "b", "w", "ll", "ok", "iters", "r", "done", "failed",
           "it_done")


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """The EM's tensors are small here: more threads only contend with the
    other test processes."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def instances_of(seed, count, tiny=False):
    rng = np.random.default_rng(seed)
    out = [_instance(rng, rng.integers(1, 4), 24) for _ in range(count)]
    return out + [TINY] if tiny else out


def sets(memberships, n):
    return [[sorted(c) for c in memberships.get(i, [])] for i in range(n)]


def oracle_sets(instances):
    oracle = MatePairEM(PARAMS)
    return [[sorted(c) for c in oracle.do_clustering(*inst)]
            for inst in instances]


def both_em_runs(batch, np_dtype, **port_kw):
    """The ten outputs of both programs on one batch, as numpy."""
    jd = jnp.dtype(np_dtype)
    td = getattr(torch, np.dtype(np_dtype).name)
    ref = jax_em.make_em_step(SIGMA)(
        jnp.asarray(batch.x, jd), jnp.asarray(batch.y, jd),
        jnp.asarray(batch.u, jd), jnp.asarray(batch.n),
        jnp.asarray(batch.k), jnp.asarray(batch.r0, jd))
    got = port_em._build_em_run(SIGMA, **port_kw)(
        *(torch.as_tensor(v, dtype=td) for v in (batch.x, batch.y, batch.u)),
        torch.as_tensor(batch.n), torch.as_tensor(batch.k),
        torch.as_tensor(batch.r0, dtype=td))
    return (dict(zip(OUTPUTS, map(np.asarray, ref))),
            dict(zip(OUTPUTS, map(np.asarray, got))))


def close(got, want, rtol):
    return np.abs(got - want) <= rtol * np.maximum(1.0, np.abs(want))


# --- (1) em_run against the JAX program ---------------------------------------

@pytest.mark.parametrize("seed,count", [(0, 12), (7, 9), (21, 14)])
def test_em_run_float64_matches_jax(seed, count):
    batch = port_em.prepare_batch(instances_of(seed, count, tiny=True),
                                  PARAMS)
    ref, got = both_em_runs(batch, np.float64)
    active = np.arange(batch.r0.shape[1])[None, :] < batch.k[:, None]
    for name in ("a", "b", "w"):
        assert close(got[name], ref[name], RTOL64)[active].all(), name
    assert close(got["ll"], ref["ll"], RTOL64).all()
    for name in ("ok", "done", "failed", "it_done"):
        np.testing.assert_array_equal(got[name], ref[name], name)
    assert int(got["iters"]) == int(ref["iters"]) > 1
    assert got["a"].dtype == np.float64 and got["it_done"].dtype == np.int32


@pytest.mark.parametrize("seed,count", [(0, 12), (7, 9), (21, 14)])
def test_em_run_float32_matches_jax(seed, count):
    batch = port_em.prepare_batch(instances_of(seed, count, tiny=True),
                                  PARAMS)
    ref, got = both_em_runs(batch, np.float32)
    assert got["ll"].dtype == got["r"].dtype == np.float32
    apart = np.abs(got["it_done"].astype(int) - ref["it_done"])
    near = close(got["ll"], ref["ll"], RTOL32)
    assert near[apart == 0].all()
    assert near.mean() >= 1 - F32_OUTLIERS
    assert (apart == 0).mean() > 0.8
    for name in ("ok", "done", "failed"):
        np.testing.assert_array_equal(got[name][apart == 0],
                                      ref[name][apart == 0], name)


def test_em_run_resumed_segments_match_one_launch():
    """A row's trajectory is the same in one launch and in segments resumed
    from the carry (``r``, ``ll``, ``a``, ``b``), bit for bit."""
    batch = port_em.prepare_batch(instances_of(3, 4), PARAMS)
    em = port_em.make_em_step(SIGMA)
    t = lambda v, dt=torch.float64: torch.as_tensor(v, dtype=dt)
    args = (t(batch.x), t(batch.y), t(batch.u), torch.as_tensor(batch.n),
            torch.as_tensor(batch.k))
    whole = em(*args, t(batch.r0))
    a, b, _w, ll, ok, iters, r, done, failed, _itd = em(
        *args, t(batch.r0), max_iters=5)
    assert iters == 5 and not bool((done | failed).all())
    seg_a, seg_b, seg_ll, total = a.clone(), b.clone(), ll.clone(), iters
    while not bool((done | failed).all()):
        live = ~(done | failed)
        a, b, _w, ll, ok, iters, r, done, failed, _itd = em(
            *args, r, ll, max_iters=5, a0=a, b0=b)
        total += iters
        assert torch.equal(a[~live], seg_a[~live])  # retired rows stay put
        seg_a, seg_b, seg_ll = a.clone(), b.clone(), ll.clone()
    assert torch.equal(seg_a, whole[0]) and torch.equal(seg_b, whole[1])
    assert torch.equal(seg_ll, whole[3])
    assert whole[5] <= total < whole[5] + 5


def massless_batch():
    """Three points of a cluster and one far away whose x + y + u is 0, at
    K = 2 with every responsibility on the first component: the second
    never moves from (0, 0), where it is the far point's best component
    with weight 0, and the first's density underflows there."""
    inst = (np.array([1000.0, 1001.0, 1002.0, -50.0]),
            np.array([2000.0, 2001.0, 2002.0, -50.0]), np.full(4, 100.0))
    batch = port_em.prepare_batch([inst], PARAMS)
    row = int(np.nonzero(batch.k == 2)[0][0])
    batch.r0[row] = 0.0
    batch.r0[row, 0, :4] = 1.0
    return batch, row


@pytest.mark.parametrize("np_dtype", [np.float64, np.float32])
def test_point_without_mass_fails_the_row(np_dtype):
    """A point whose mixture mass is 0 marks its row failed, as in the JAX
    program; its responsibilities are 0 over 1e-300 in float64 and 0 over 0
    (1e-300 rounds to 0) in float32.  ``run_em`` reports the row as not ok
    from one launch and from the bucketed run."""
    batch, row = massless_batch()
    ref, got = both_em_runs(batch, np_dtype)
    assert got["failed"][row] and not got["ok"][row]
    for name in ("ok", "done", "failed", "it_done"):
        np.testing.assert_array_equal(got[name], ref[name], name)
    np.testing.assert_array_equal(np.isnan(got["r"]), np.isnan(ref["r"]))
    assert np.isnan(got["r"][row]).any() == (np_dtype is np.float32)
    for chunk in (0, None, 2):
        ok = port_em.run_em(batch, PARAMS, np_dtype, "cpu", chunk)[3]
        np.testing.assert_array_equal(ok, ref["ok"])


# --- (2) the M-step alone -------------------------------------------------------

def jax_static(x, y, u, n):
    """The static operand of the JAX ``_m_step``, as its ``em_run`` builds
    it (``defuse_tpu/cluster/matepair_em_batch.py:464-500``)."""
    x, y, u, n = (jnp.asarray(v) for v in (x, y, u, n))
    N = x.shape[1]
    big = jnp.asarray(jax_em.BIG, x.dtype)
    point_valid = jnp.arange(N)[None, :] < n[:, None]
    orders = [jnp.argsort(jnp.where(point_valid, -v, big), axis=1,
                          stable=True).astype(jnp.int32) for v in (x, y)]
    sorted_vals = [jnp.take_along_axis(v, o, axis=1)
                   for v, o in zip((x, y), orders)]

    def runends(vals, valid):
        nxt = jnp.concatenate([vals[:, 1:], vals[:, -1:]], axis=1)
        nxt_valid = jnp.concatenate(
            [valid[:, 1:], jnp.zeros_like(valid[:, :1])], axis=1)
        return valid & ((vals != nxt) | ~nxt_valid)

    n_valid = jnp.sum(point_valid, axis=1)[:, None]
    sides = [jax_em._side_static(
        vals, runends(vals, jnp.take_along_axis(point_valid, o, axis=1)),
        n_valid) for vals, o in zip(sorted_vals, orders)]
    iota = jnp.arange(N, dtype=jnp.int32)
    onehots = [o[:, :, None] == iota[None, None, :] for o in orders]
    return (x, y, u, point_valid, *onehots, *sorted_vals, *sides)


def m_step_case(kind, seed):
    """(x, y, u, n, k, r): a padded batch of four instances at every K and
    the responsibilities the M-step gets."""
    rng = np.random.default_rng(seed)
    instances = [_instance(rng, rng.integers(1, 4), 24) for _ in range(4)]
    if kind == "runs":
        # coordinates rounded to 20: many points share an x or a y
        instances = [(np.round(x / 20) * 20, np.round(y / 20) * 20, u)
                     for x, y, u in instances]
    batch = port_em.prepare_batch(instances + [TINY], PARAMS)
    if kind == "seeded":
        return batch, batch.r0
    active = (np.arange(batch.r0.shape[1])[None, :, None]
              < batch.k[:, None, None])
    valid = np.arange(batch.x.shape[1])[None, None, :] \
        < batch.n[:, None, None]
    r = rng.random(batch.r0.shape) * active
    if kind == "sparse":
        # components without mass on most points: long runs of equal sums
        r = r * (rng.random(r.shape) < 0.3)
    r = r / np.maximum(r.sum(axis=1, keepdims=True), 1e-300)
    return batch, np.where(valid, r, rng.random(r.shape))  # padding is masked


@pytest.mark.parametrize("seed", [1, 2])
@pytest.mark.parametrize("kind", ["seeded", "random", "runs", "sparse"])
def test_m_step_matches_jax(kind, seed):
    batch, r = m_step_case(kind, seed)
    a_ref, b_ref, ok_ref = (np.asarray(o) for o in jax_em._m_step(
        jnp.asarray(r), jax_static(batch.x, batch.y, batch.u, batch.n),
        SIGMA, LAMBDA))
    x, y, u = (torch.as_tensor(v) for v in (batch.x, batch.y, batch.u))
    n = torch.as_tensor(batch.n)
    point_valid = torch.arange(x.shape[1])[None, :] < n[:, None]
    a, b, ok = (o.numpy() for o in port_em._m_step(
        torch.as_tensor(r), port_em._batch_static(x, y, u, point_valid),
        SIGMA, LAMBDA))
    np.testing.assert_array_equal(ok, ok_ref)
    masked = np.arange(r.shape[1])[None, :] >= batch.k[:, None]
    assert not ok[masked].any() and ok[~masked].any()
    assert close(a, a_ref, RTOL64)[ok].all()
    assert close(b, b_ref, RTOL64)[ok].all()
    if kind == "runs":
        assert (np.diff(np.sort(batch.x[0, :batch.n[0]])) == 0).any()


def test_m_step_holds_no_pairwise_mask():
    """Nothing the M-step's static operand holds is (B, N, N): the orders
    are index vectors, not one-hot masks."""
    batch = port_em.prepare_batch(instances_of(1, 3), PARAMS)
    x, y, u = (torch.as_tensor(v) for v in (batch.x, batch.y, batch.u))
    point_valid = torch.arange(x.shape[1])[None, :] \
        < torch.as_tensor(batch.n)[:, None]
    static = port_em._batch_static(x, y, u, point_valid)
    tensors = [t for t in static if torch.is_tensor(t)] + \
        [t for side in static[-2:] for t in side.values()]
    assert len(tensors) == 8 + 2 * 6
    assert all(t.dim() == 2 for t in tensors)


@pytest.mark.parametrize("seed", range(3))
def test_tie_counts_match_pairwise_compare(seed):
    """``searchsorted`` on a sorted, BIG-padded side gives the integers of
    the reference's compare-every-pair count, ties included."""
    rng = np.random.default_rng(seed)
    inf = float(port_em.BIG)
    o = np.sort(rng.integers(0, 6, size=(3, 4, 11)).astype(float), axis=2)
    t = np.sort(rng.integers(0, 6, size=(3, 4, 11)).astype(float), axis=2)
    o[:, :, 8:] = inf
    t[:, :, 9:] = inf
    lt = (o[:, :, :, None] < t[:, :, None, :]).sum(axis=2)
    le = (o[:, :, :, None] <= t[:, :, None, :]).sum(axis=2)
    ot, tt = torch.as_tensor(o), torch.as_tensor(t)
    np.testing.assert_array_equal(
        torch.searchsorted(ot, tt, right=False).numpy(), lt)
    np.testing.assert_array_equal(
        torch.searchsorted(ot, tt, right=True).numpy(), le)
    assert (le - lt).max() > 1


def test_run_cumsum_repairs_a_parallel_scan():
    """``_run_cumsum`` equals ``cumsum`` where the scan runs left to right,
    and a scan that rounds each prefix on its own still comes out
    nondecreasing and flat across zero addends."""
    rng = np.random.default_rng(4)
    rs = torch.as_tensor(rng.random((2, 3, 40)) * (rng.random((2, 3, 40))
                                                   < 0.4))
    exact = torch.cumsum(rs, 2)
    assert torch.equal(port_em._run_cumsum(rs), exact)
    jitter = torch.as_tensor(1 + 1e-12 * rng.standard_normal((2, 3, 40)))
    with um.patch.object(torch, "cumsum", lambda v, d: exact * jitter):
        assert not bool((torch.cumsum(rs, 2).diff(dim=2) >= 0).all())
        got = port_em._run_cumsum(rs)
    steps = got.diff(dim=2)
    assert bool((steps >= 0).all())
    assert bool((steps[rs[:, :, 1:] == 0] == 0).all())
    assert torch.allclose(got, exact, rtol=1e-9, atol=0)


# --- (3) run_batch: memberships -------------------------------------------------

@pytest.mark.parametrize("kw", [
    dict(), dict(chunk_rows=0), dict(dtype=torch.float64, chunk_rows=16),
    dict(dtype=np.float64, exact_resolve=True)],
    ids=["default", "one-launch", "slabs-of-16", "f64-exact-resolve"])
def test_membership_agreement(kw):
    instances = instances_of(0, 12, tiny=True)
    want = oracle_sets(instances)
    got = port_em.run_batch(port_em.prepare_batch(instances, PARAMS), PARAMS,
                            device="cpu", **kw)
    assert sets(got, len(instances)) == want
    ref = jax_em.run_batch(jax_em.prepare_batch(instances, JAX_PARAMS),
                           JAX_PARAMS)
    assert sets(got, len(instances)) == sets(ref, len(instances))
    stats = port_em.LAST_SELECT_STATS
    assert stats["n_instances"] == 13
    assert stats["exact_resolve"] == bool(kw.get("exact_resolve"))
    if not kw.get("exact_resolve"):
        assert stats["n_host_resolved"] == 0


@pytest.mark.parametrize("dtype", [torch.float64, torch.float32])
@pytest.mark.parametrize("chunk", [1, 7, 1000])
def test_chunked_run_batch_identical(dtype, chunk):
    """Slabs (several a group, a short one last), segments and compaction
    against one launch of the whole batch at its padded width."""
    instances = instances_of(7, 9)
    batch = port_em.prepare_batch(instances, PARAMS)
    assert len(batch.n) > 7
    want = port_em.run_batch(batch, PARAMS, dtype=dtype, device="cpu",
                             chunk_rows=0, exact_resolve=False)
    assert port_em.EM_RUN_STATS == {}
    got = port_em.run_batch(batch, PARAMS, dtype=dtype, device="cpu",
                            chunk_rows=chunk, exact_resolve=False)
    assert sets(got, 9) == sets(want, 9)
    stats = port_em.EM_RUN_STATS
    assert stats["rows"] == len(batch.n) and stats["groups"] >= 2
    assert stats["slabs"] >= stats["segments"] >= stats["groups"]
    assert stats["row_iters_live"] <= stats["row_iters_run"]
    if chunk == 1:
        assert stats["row_iters_live"] == stats["row_iters_run"]
    assert set(stats) >= {"t_upload", "t_dispatch", "t_device_wait",
                          "t_pull", "up_MB", "down_MB", "slabs", "groups",
                          "segments", "wall_s"}


@pytest.mark.parametrize("chunk", [None, 0, 5])
def test_exact_resolve_f32_matches_oracle(chunk):
    """float32 with the host re-solve of the instances inside the drift
    margins equals the float64 oracle exactly."""
    instances = instances_of(21, 14, tiny=True)
    got = port_em.run_batch(port_em.prepare_batch(instances, PARAMS), PARAMS,
                            dtype=np.float32, device="cpu", chunk_rows=chunk)
    assert port_em.LAST_SELECT_STATS["exact_resolve"]
    assert sets(got, len(instances)) == oracle_sets(instances)


@pytest.mark.parametrize("chunk", [None, 0])
def test_float32_runs_on_centred_coordinates(chunk):
    """``run_em`` in float32 moves each row's origin to its least
    coordinates (seven digits do not hold a genome coordinate and its
    fractions): the breakpoints come back in the caller's coordinates, as
    close to the float64 run's as float32 is on numbers of the bin pair's
    own width (half of them within 0.001 base and all within 0.5: the runs
    stop on ``|Δll| < 1e-3``, not at the optimum), and a component that
    never had mass comes back as the 0 it is in float64."""
    instances = instances_of(0, 6)
    shifted = [(x + 3.0e7, y + 1.5e8, u) for x, y, u in instances]
    batch = port_em.prepare_batch(shifted, PARAMS)
    a64, b64, ll64, ok64 = port_em.run_em(batch, PARAMS, torch.float64,
                                          "cpu", chunk)
    a32, b32, ll32, ok32 = port_em.run_em(batch, PARAMS, np.float32, "cpu",
                                          chunk)
    assert a32.dtype == b32.dtype == np.float64 and ll32.dtype == np.float32
    never = (a64 == 0) & (b64 == 0)
    assert never.any() and (a32[never] == 0).all() and (b32[never] == 0).all()
    same = ok64 & ok32 & close(ll32, ll64, RTOL32)
    assert same.mean() > 0.9
    alive = ~never & same[:, None]
    for got, want in ((a32, a64), (b32, b64)):
        apart = np.abs(got - want)[alive]
        assert np.median(apart) < 1e-3 and apart.max() < 0.5
    assert a32[alive].min() > 2.9e7 and b32[alive].min() > 1.4e8


def test_native_seed_batch_matches_python():
    """``prepare_batch``'s native seeding gives the ``r0`` of the per-row
    Python ``_seed`` bit for bit, and both packages' batches are equal."""
    if not native.available():
        pytest.skip("native library not built")
    rng = np.random.default_rng(11)
    instances = [_instance(rng, rng.integers(1, 4), 24) for _ in range(20)]
    # degenerate geometry: one distinct point repeated (KKZ fails)
    instances.append((np.full(8, 5.0), np.full(8, 7.0), np.full(8, 100.0)))
    with um.patch.object(port_em, "_seed",
                         side_effect=AssertionError("python _seed ran")):
        b_native = port_em.prepare_batch(instances, PARAMS)
    with um.patch.object(native, "available", lambda: False):
        b_py = port_em.prepare_batch(instances, PARAMS)
    assert len(b_native.n) > 64  # native path engaged (size gate)
    assert np.array_equal(b_native.r0, b_py.r0)
    b_ref = jax_em.prepare_batch(instances, JAX_PARAMS)
    for field in ("x", "y", "u", "n", "k", "r0", "xo_idx", "yo_idx",
                  "x_runend", "y_runend", "instance"):
        np.testing.assert_array_equal(getattr(b_native, field),
                                      getattr(b_ref, field), field)


def test_native_seed_failure_is_raised():
    """Only a library without the entry point (AttributeError) sends
    ``prepare_batch`` to the Python seeds; another failure is raised."""
    if not native.available():
        pytest.skip("native library not built")
    instances = instances_of(11, 20)
    want = port_em.prepare_batch(instances, PARAMS).r0
    with um.patch.object(native, "em_seed_batch",
                         side_effect=AttributeError("dt_em_seed_batch")):
        assert np.array_equal(port_em.prepare_batch(instances, PARAMS).r0,
                              want)
    with um.patch.object(native, "em_seed_batch",
                         side_effect=ValueError("bad rows")):
        with pytest.raises(ValueError, match="bad rows"):
            port_em.prepare_batch(instances, PARAMS)


def test_exact_resolve_native_and_oracle_identical():
    """The re-solves go through the native solver when built; the answer is
    the Python oracle's."""
    if not native.available():
        pytest.skip("native library not built")
    instances = instances_of(33, 10)
    batch = port_em.prepare_batch(instances, PARAMS)
    via_native = port_em.run_batch(batch, PARAMS, dtype=np.float32,
                                   device="cpu")
    assert port_em.LAST_SELECT_STATS["exact_resolve"]
    with um.patch.object(native, "available", lambda: False):
        via_oracle = port_em.run_batch(batch, PARAMS, dtype=np.float32,
                                       device="cpu")
    assert sets(via_native, 10) == sets(via_oracle, 10)


def test_prepare_batch_without_rows():
    assert port_em.prepare_batch([], PARAMS) is None
    assert port_em.prepare_batch([(np.zeros(2), np.zeros(2), np.zeros(2))],
                                 PARAMS) is None


# --- (4) the loop's check interval ----------------------------------------------

@pytest.mark.parametrize("check_every", [2, 4, 7, 1000])
@pytest.mark.parametrize("max_iters", [300, 10])
def test_check_interval_changes_no_output(check_every, max_iters):
    """Asking the device once in a few iterations returns the ten outputs
    of asking every iteration, the iteration count included: the rows that
    finished are frozen."""
    batch = port_em.prepare_batch(instances_of(5, 5, tiny=True), PARAMS)
    args = [torch.as_tensor(v, dtype=torch.float64)
            for v in (batch.x, batch.y, batch.u)] + \
        [torch.as_tensor(batch.n), torch.as_tensor(batch.k),
         torch.as_tensor(batch.r0, dtype=torch.float64)]
    want = port_em._build_em_run(SIGMA, check_every=1)(
        *args, max_iters=max_iters)
    got = port_em._build_em_run(SIGMA, check_every=check_every)(
        *args, max_iters=max_iters)
    for name, w, g in zip(OUTPUTS, want, got):
        if name == "iters":
            assert g == w and (max_iters == 10) == (w == 10)
        else:
            assert torch.equal(g, w), name


# --- (5) the device ---------------------------------------------------------------

@pytest.mark.parametrize("kw", [dict(), dict(chunk_rows=0),
                                dict(dtype=np.float32)])
def test_run_batch_needs_cuda_when_asked(kw):
    if torch.cuda.is_available():
        pytest.skip("CUDA is available here")
    batch = port_em.prepare_batch(instances_of(0, 2), PARAMS)
    with pytest.raises(RuntimeError, match="is_available"):
        port_em.run_batch(batch, PARAMS, **kw)
    with pytest.raises(RuntimeError, match="is_available"):
        port_em.run_batch(batch, PARAMS, device="cuda:0", **kw)
