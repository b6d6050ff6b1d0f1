"""Batched mate-pair EM — the device path, in PyTorch.

Counterpart of ``defuse_tpu/cluster/matepair_em_batch.py``.  It vectorizes
the reference's per-bin-pair mixture EM (see ``cluster/matepair_em.py`` for
the exact host oracle and the ``tools/MatePairEM.cpp`` citations) across
many bin-pair instances and all candidate component counts K at once:

* every (instance, K) pair becomes one batch element; K-masked components
  keep zero responsibilities and are excluded from the likelihood;
* seeding (KKZ + AS 136 k-means) runs on the host — it is inherently
  point-sequential and tiny — producing one-hot responsibilities that are
  shipped to the device once;
* the exact piecewise-linear M-step is vectorized by enumerating the
  merged breakpoint events of the two responsibility cumsums instead of
  the reference's sequential two-pointer merge
  (``MatePairEM.cpp:192-325``); the chosen breakpoint is the first event
  with positive derivative, exactly as in the reference;
* BIC selection over K is an argmin per instance (first minimum wins,
  matching the strict ``<`` in ``MatePairEM.cpp:601``).

The host half (``EMBatch`` to ``_select_kkz``, the shape buckets,
``select_memberships``) is the reference's text.  The device program is
plain PyTorch on the tensors' own device, with no hand-written kernel: on a
CUDA device it runs there or ``run_batch`` raises, and ``device="cpu"``
runs the same code on CPU tensors.  Where the reference works around slow
minor-axis gathers with one-hot masks and counts ties by an all-pairs
compare, this uses ``torch.gather`` and ``torch.searchsorted``; the counts
are the same integers.

The device path is *decision-equivalent* to the oracle (same memberships);
bit-level float trajectories differ because reductions are parallel.
``tests/test_torch_em_batch.py`` holds it to the JAX program and to the
oracle.
"""

from __future__ import annotations

import dataclasses
import time

import numpy as np
import torch

from ..core.devices import require_cuda
from .kmeans import kmns
from .matepair_em import K_MAX, LAMBDA, TOLERANCE, EMParams

MAX_ITERS = 300
BIG = np.float64(1e30)


# ---------------------------------------------------------------------------
# Host-side preparation
# ---------------------------------------------------------------------------

@dataclasses.dataclass
class EMBatch:
    """Padded batch of (instance, K) EM problems."""
    x: np.ndarray          # (B, N)
    y: np.ndarray          # (B, N)
    u: np.ndarray          # (B, N)
    n: np.ndarray          # (B,) valid points
    k: np.ndarray          # (B,) active components
    r0: np.ndarray         # (B, KMAX, N) initial responsibilities
    xo_idx: np.ndarray     # (B, N) descending-x sort order (stable)
    yo_idx: np.ndarray     # (B, N)
    x_runend: np.ndarray   # (B, N) bool: last position of a value run
    y_runend: np.ndarray   # (B, N)
    instance: np.ndarray   # (B,) original instance id


def prepare_batch(instances, params: EMParams, k_max: int = K_MAX,
                  pad_n: int | None = None) -> EMBatch | None:
    """Build an EMBatch from [(x, y, u)] float64 arrays.

    Expands each instance into one element per candidate K (1..min(kmax,n))
    with host-computed seeds.
    """
    rows = []
    for inst_id, (x, y, u) in enumerate(instances):
        n = len(x)
        if n < params.min_cluster_size:
            continue  # MatePairEM.cpp:542-545
        for k in range(1, min(k_max, n) + 1):
            rows.append((inst_id, k, x, y, u))
    if not rows:
        return None

    # Seeds via the threaded native KKZ + AS136 batch when built (the
    # per-row Python kmns dominates the preparation of a large batch).
    # Identical math (shared kmns twin, same fallback set), so R0 is
    # unchanged.
    seed_ic1 = seed_uniform = seed_offs = None
    if len(rows) > 64:
        from . import native as _native
        if _native.available():
            try:
                seed_ic1, seed_uniform, seed_offs = _native.em_seed_batch(
                    instances, rows)
            except AttributeError:
                # a library built before dt_em_seed_batch existed: the
                # Python _seed below; any other failure is raised
                seed_ic1 = None

    max_n = pad_n or max(len(r[2]) for r in rows)
    B = len(rows)
    X = np.zeros((B, max_n))
    Y = np.zeros((B, max_n))
    U = np.zeros((B, max_n))
    N = np.zeros(B, dtype=np.int32)
    K = np.zeros(B, dtype=np.int32)
    R0 = np.zeros((B, k_max, max_n))
    XOI = np.zeros((B, max_n), dtype=np.int32)
    YOI = np.zeros((B, max_n), dtype=np.int32)
    XRE = np.zeros((B, max_n), dtype=bool)
    YRE = np.zeros((B, max_n), dtype=bool)
    INST = np.zeros(B, dtype=np.int32)

    for b, (inst_id, k, x, y, u) in enumerate(rows):
        n = len(x)
        X[b, :n] = x
        Y[b, :n] = y
        U[b, :n] = u
        N[b] = n
        K[b] = k
        INST[b] = inst_id
        xo = np.argsort(-np.asarray(x), kind="stable")
        yo = np.argsort(-np.asarray(y), kind="stable")
        XOI[b, :n] = xo
        XOI[b, n:] = n - 1 if n else 0
        YOI[b, :n] = yo
        YOI[b, n:] = n - 1 if n else 0
        xs = np.asarray(x)[xo]
        ys = np.asarray(y)[yo]
        XRE[b, :n] = np.r_[xs[:-1] != xs[1:], True]
        YRE[b, :n] = np.r_[ys[:-1] != ys[1:], True]
        if seed_ic1 is not None:
            if seed_uniform[b]:
                R0[b, :k, :n] = 1.0 / k
            else:
                ic1 = seed_ic1[seed_offs[b]:seed_offs[b] + n]
                R0[b, ic1, np.arange(n)] = 1.0
        else:
            R0[b, :k, :n] = _seed(np.asarray(x), np.asarray(y), k)

    return EMBatch(X, Y, U, N, K, R0, XOI, YOI, XRE, YRE, INST)


def _seed(x: np.ndarray, y: np.ndarray, k: int) -> np.ndarray:
    """Initial responsibilities: uniform for K in {1, N}, else KKZ +
    AS136 k-means one-hot (``MatePairEM.cpp:405-453``)."""
    n = len(x)
    if k == 1 or k == n:
        return np.full((k, n), 1.0 / k)
    px, py = _select_kkz(x, y, k)
    if px is None:
        # degenerate geometry: fall back to uniform (the reference
        # reports EM failure for this K; BIC will rarely choose it)
        return np.full((k, n), 1.0 / k)
    a_mat = np.stack([y, x], axis=1)
    c_mat = np.stack([py, px], axis=1)
    ic1, _, _, ifault = kmns(a_mat, c_mat)
    if ic1 is None:
        return np.full((k, n), 1.0 / k)
    onehot = np.zeros((k, n))
    onehot[ic1, np.arange(n)] = 1.0
    return onehot


def _select_kkz(x, y, k):
    l2 = x * y
    i_max = int(np.argmax(l2))  # first max (ties) — matches strict >
    ax = [x[i_max]]
    ay = [y[i_max]]
    dist = (x - ax[0]) ** 2 + (y - ay[0]) ** 2
    while len(ax) < k:
        i_far = int(np.argmax(dist))
        if dist[i_far] == 0.0:
            return None, None
        ax.append(x[i_far])
        ay.append(y[i_far])
        dist = np.minimum(dist, (x - ax[-1]) ** 2 + (y - ay[-1]) ** 2)
    return np.asarray(ax), np.asarray(ay)


# ---------------------------------------------------------------------------
# Device EM
# ---------------------------------------------------------------------------

def _exponents(a, b, x, y, u, sigma, lam):
    # a,b: (B,K); x,y,u: (B,N) -> (B,K,N)
    diff = (a[..., None] + b[..., None]
            - x[:, None, :] - y[:, None, :] - u[:, None, :]) / sigma
    return (-0.5 * diff * diff
            - lam * torch.clamp_min(x[:, None, :] - a[..., None], 0.0)
            - lam * torch.clamp_min(y[:, None, :] - b[..., None], 0.0))


def _run_cumsum(rs):
    """Running sums of the nonnegative ``rs`` (B, K, N) along the last axis
    with the two properties of a left-to-right sum that the event merge
    rests on: they never decrease, and they do not change across a zero
    addend.  A parallel scan rounds each prefix along its own tree, so on
    a CUDA device neither holds by itself; equal sums are what pairs the
    runs of the two sides (``MatePairEM.cpp:210-222``), and sorted sums
    are what ``torch.searchsorted`` needs."""
    cum = torch.cummax(torch.cumsum(rs, 2), 2).values
    iota = torch.arange(rs.shape[2], device=rs.device).expand_as(rs)
    last_nonzero = torch.cummax(torch.where(rs != 0, iota, 0), 2).values
    return torch.gather(cum, 2, last_nonzero)


def _side_static(sorted_vals, runend, n_valid):
    """Loop-invariant per-side structures for the M-step event merge.

    Everything here depends only on the coordinate sort order — NOT on
    the responsibilities — so it is computed once per EM problem and
    kept through the loop instead of being rebuilt every iteration.
    """
    B, N = sorted_vals.shape
    iota = torch.arange(N, device=sorted_vals.device)[None, :]
    # run-end positions first, in order (a stable sort of an integer key)
    order = torch.sort((~runend).to(torch.int8), dim=1,
                       stable=True).indices
    count = runend.sum(dim=1)
    mvalid = iota < count[:, None]
    rpos = torch.where(mvalid, order, N - 1)             # (B, N)
    # value at each run end / at the next sorted position
    runend_vals = torch.gather(sorted_vals, 1, rpos)
    runend_next = torch.gather(sorted_vals, 1,
                               torch.clamp(rpos + 1, 0, N - 1))
    has_next = (rpos + 1) < n_valid                      # (B, N)
    n_runs = count[:, None]                              # (B, 1)
    return dict(rpos=rpos, mvalid=mvalid, runend_vals=runend_vals,
                runend_next=runend_next, has_next=has_next, n_runs=n_runs)


def _batch_static(x, y, u, point_valid):
    """The loop-invariant operand of ``_m_step``: the points, their
    descending-x and descending-y orders (stable, padding last) and each
    side's run-end tables, computed on the tensors' device."""
    big = float(BIG)
    xo_idx = torch.sort(torch.where(point_valid, -x, big), dim=1,
                        stable=True).indices
    yo_idx = torch.sort(torch.where(point_valid, -y, big), dim=1,
                        stable=True).indices
    xo = torch.gather(x, 1, xo_idx)
    yo = torch.gather(y, 1, yo_idx)

    def runends(sorted_vals, valid):
        nxt = torch.cat([sorted_vals[:, 1:], sorted_vals[:, -1:]], dim=1)
        nxt_valid = torch.cat(
            [valid[:, 1:], torch.zeros_like(valid[:, :1])], dim=1)
        return valid & ((sorted_vals != nxt) | ~nxt_valid)

    x_runend = runends(xo, torch.gather(point_valid, 1, xo_idx))
    y_runend = runends(yo, torch.gather(point_valid, 1, yo_idx))
    n_valid = point_valid.sum(dim=1)[:, None]
    return (x, y, u, point_valid, xo_idx, yo_idx, xo, yo,
            _side_static(xo, x_runend, n_valid),
            _side_static(yo, y_runend, n_valid))


def _m_step(r, batch_static, sigma, lam):
    """Exact piecewise-linear M-step, vectorized over (B, K).

    r: (B, K, N) responsibilities.  Returns a, b: (B, K) and ok mask.

    Data-dependent indexing is ``torch.gather`` along the point axis, and
    the two-pointer merge's positions on the other side are binary
    searches (``torch.searchsorted``) over its sorted run-end sums: the
    same integer counts as comparing every pair of runs.
    """
    (x, y, u, point_valid, xo_idx, yo_idx, xo, yo,
     xs_static, ys_static) = batch_static
    B, K, N = r.shape

    rm = torch.where(point_valid[:, None, :], r, 0.0)
    nk = rm.sum(dim=2)                                   # (B, K)
    rxyu = (rm * (x + y + u)[:, None, :]).sum(dim=2)

    # rm in coordinate-sorted order: rxo[b,k,q] = rm[b,k,xo_idx[b,q]]
    sx = _run_cumsum(torch.gather(rm, 2, xo_idx[:, None, :].expand(B, K, N)))
    sy = _run_cumsum(torch.gather(rm, 2, yo_idx[:, None, :].expand(B, K, N)))

    # --- event construction at value-run granularity --------------------
    # The reference's two-pointer merge walks *runs* of equal coordinate
    # values (``MatePairEM.cpp:210-222`` skips duplicate coordinates).  At
    # each merge step it emits the current (x_run, y_run) pair at
    # threshold t = min(SX, SY), plus an "advanced" pair: the next x-run
    # when SX < SY, the next y-run when SY < SX, and BOTH advanced when
    # SX == SY (the == branch).  We enumerate the same entries per run
    # end, resolving the active other-side run (and tie advancement) with
    # lt/le counts over the other side's run-end cumsums.
    inf = float(BIG)

    def rcum_at_runends(cum, side):
        rcum = torch.gather(cum, 2, side["rpos"][:, None, :].expand(B, K, N))
        return torch.where(side["mvalid"][:, None, :], rcum, inf)

    x_rcum = rcum_at_runends(sx, xs_static)
    y_rcum = rcum_at_runends(sy, ys_static)
    idxN = torch.arange(N, device=r.device)[None, None, :]

    def entries_for(source_is_x):
        if source_is_x:
            side, rcum = xs_static, x_rcum
            o_side, o_rcum = ys_static, y_rcum
        else:
            side, rcum = ys_static, y_rcum
            o_side, o_rcum = xs_static, x_rcum
        t = rcum  # (B, K, N) event thresholds (inf where invalid)

        # rank of this run among equal-cum self runs.  rcum is
        # nondecreasing along the run axis (inf-padded), so the count of
        # strictly-smaller self entries is the first index of the
        # equal-value block: an O(N) cummax
        is_new = torch.cat(
            [torch.ones_like(rcum[:, :, :1], dtype=torch.bool),
             rcum[:, :, 1:] != rcum[:, :, :-1]], dim=2)
        n_self_lt = torch.cummax(torch.where(is_new, idxN, 0), dim=2).values
        rank = idxN - n_self_lt

        # other-side structure at t: the two-pointer merge pairs equal-cum
        # runs by rank (== branch advances both), then parks on the first
        # other run beyond t (< branch).  Both sides are sorted, so the
        # lt/le counts are two binary searches a threshold.
        o_sorted = o_rcum.contiguous()
        n_o_lt = torch.searchsorted(o_sorted, t.contiguous(), right=False)
        n_o_le = torch.searchsorted(o_sorted, t.contiguous(), right=True)
        n_o_ties = n_o_le - n_o_lt
        n_o_runs = o_side["n_runs"][:, None, :]

        tie = rank < n_o_ties
        o_idx = n_o_lt + torch.minimum(rank, n_o_ties)
        event_exists = tie | (n_o_lt + n_o_ties < n_o_runs)
        o_idx = torch.clamp(o_idx, 0, N - 1)

        # all remaining dynamic indexing happens through o_idx on static
        # (B, N) run-end vectors (values, advanced values, has-next flag)
        def pick(vals):
            return torch.gather(vals[:, None, :].expand(B, K, N), 2, o_idx)

        other_primary = pick(o_side["runend_vals"])
        other_adv_raw = pick(o_side["runend_next"])
        other_has_next = pick(o_side["has_next"])

        self_primary = side["runend_vals"][:, None, :].expand(B, K, N)
        self_adv = side["runend_next"][:, None, :].expand(B, K, N)
        self_has_next = side["has_next"][:, None, :].expand(B, K, N)

        other_adv = torch.where(tie, other_adv_raw, other_primary)
        adv_valid = self_has_next & (other_has_next | ~tie)
        valid = side["mvalid"][:, None, :] & (t < inf) & event_exists

        if source_is_x:
            return (t, self_primary, other_primary,
                    self_adv, other_adv, valid, valid & adv_valid)
        return (t, other_primary, self_primary,
                other_adv, self_adv, valid, valid & adv_valid)

    tx, xcx1, xcy1, xcx2, xcy2, xv1, xv2 = entries_for(True)
    ty, ycx1, ycy1, ycx2, ycy2, yv1, yv2 = entries_for(False)

    ent_t = [rm.new_zeros((B, K, 1)), tx, tx, ty, ty]
    ent_cx = [xo[:, None, :1].expand(B, K, 1), xcx1, xcx2, ycx1, ycx2]
    ent_cy = [yo[:, None, :1].expand(B, K, 1), xcy1, xcy2, ycy1, ycy2]
    ent_valid = [torch.ones((B, K, 1), dtype=torch.bool, device=r.device),
                 xv1, xv2, yv1, yv2]
    # path-order tiebreak code: tier (primary-before-advanced) then run
    code = torch.cat(
        [torch.zeros(1, dtype=torch.int64, device=r.device)]
        + [tier * N + idxN[0, 0] + 1 for tier in (1, 2, 3, 4)])

    T = torch.cat(ent_t, dim=2)
    CX = torch.cat(ent_cx, dim=2)
    CY = torch.cat(ent_cy, dim=2)
    VALID = torch.cat(ent_valid, dim=2)
    CODE = code[None, None, :]

    # The derivative ``partial`` is nondecreasing along the merge path
    # (CS nondecreasing, CX+CY nonincreasing), so the reference's
    # first-positive scan reduces to: among positive entries, the
    # lexicographic minimum of (t, partial, path-code) — no sort needed.
    sigma2 = sigma * sigma
    partial = (rxyu[..., None] - nk[..., None] * (CX + CY)) / sigma2 \
        + lam * T
    positive = (partial > 0) & VALID

    def select(mask, key_t, key_p, key_c, minimize):
        big_t = inf if minimize else -inf
        big_c = (1 << 30) if minimize else -(1 << 30)
        best = torch.amin if minimize else torch.amax
        t_sel = best(torch.where(mask, key_t, big_t), dim=2, keepdim=True)
        mask2 = mask & (key_t == t_sel)
        p_sel = best(torch.where(mask2, key_p, big_t), dim=2, keepdim=True)
        mask3 = mask2 & (key_p == p_sel)
        c_sel = best(torch.where(mask3, key_c, big_c), dim=2, keepdim=True)
        return mask3 & (key_c == c_sel)

    any_pos = positive.any(dim=2)

    sel_pos = select(positive, T, partial, CODE, minimize=True)
    nonpos = VALID & ~positive
    any_nonpos = nonpos.any(dim=2)
    sel_prev = select(nonpos, T, partial, CODE, minimize=False)
    # no positive derivative: reference behaviour is to park on the last
    # entry (guarded UB, cluster/matepair_em.py); use the path-last entry
    sel_mi = torch.where(any_pos[..., None], sel_pos, sel_prev)

    def gather(vals, sel):
        return torch.where(sel, vals, 0.0).sum(dim=2)

    cs_mi = gather(T, sel_mi)
    cx_mi = gather(CX, sel_mi)
    cy_mi = gather(CY, sel_mi)
    cs_pv = gather(T, sel_prev)
    cx_pv = gather(CX, sel_prev)
    cy_pv = gather(CY, sel_prev)

    ok = nk > 0.0
    nk_safe = torch.where(ok, nk, 1.0)
    aplusb = (rxyu + sigma2 * lam * cs_mi) / nk_safe

    # three cases (MatePairEM.cpp:304-322)
    a0 = 0.5 * (cx_mi + (aplusb - cy_mi))
    case_break = (cs_mi != cs_pv) | ~any_pos | ~any_nonpos
    a_break = cx_mi
    b_break = cy_mi
    min_a = torch.maximum(cx_mi, aplusb - cy_pv)
    max_a = torch.minimum(cx_pv, aplusb - cy_mi)
    a_mid = 0.5 * (min_a + max_a)

    # minindex == 0  <=>  the initial path entry is already positive
    first = positive[:, :, 0]
    a = torch.where(first, a0, torch.where(case_break, a_break, a_mid))
    b = torch.where(first, aplusb - a0,
                    torch.where(case_break, b_break, aplusb - a_mid))
    return a, b, ok


# The loop asks the device whether every row has finished once in this many
# iterations (each question waits for the device).  Finished rows are
# frozen, so the iterations past the end change no row, and the iteration
# count returned is the one at which the last row finished.
CHECK_EVERY = 4


def _build_em_run(sigma: float, lam: float = LAMBDA,
                  tol: float = TOLERANCE, check_every: int = CHECK_EVERY):
    """The batched EM loop — shared by the plain entry
    (``make_em_step``) and the device-resident slab step
    (``make_em_slab_step``)."""

    def em_run(x, y, u, n, k, r0, ll0=None, max_iters=MAX_ITERS,
               a0=None, b0=None):
        """One EM drive: runs up to ``max_iters`` iterations from the
        responsibilities ``r0`` (fresh seeds or a resumed carry) and the
        per-row last log-likelihood ``ll0`` (-BIG for fresh rows; a
        resumed carry also brings its ``a0``, ``b0``, which a component
        left without mass keeps).
        Returns (a, b, w, ll, ok, iters, r, done, failed, it_done) so a
        caller can compact converged rows out and resume the stragglers
        — per-row trajectories are identical whether run in one launch
        or in resumed segments (every op is row-independent)."""
        B, KM, N = r0.shape
        dev, dtype = x.device, x.dtype
        big = float(BIG)
        # 1e-300 in the carry's type: 0 in float32, where a point without
        # mass then divides 0 by 0 and the row is marked failed
        floor = torch.tensor(1e-300, dtype=dtype).item()
        tiny = torch.finfo(dtype).tiny
        point_valid = torch.arange(N, device=dev)[None, :] < n[:, None]
        comp_active = torch.arange(KM, device=dev)[None, :] < k[:, None]

        static = _batch_static(x, y, u, point_valid)
        n_points = torch.clamp_min(n, 1).to(dtype)[:, None]

        def ll_and_norm(a, b, w):
            exps = _exponents(a, b, x, y, u, sigma, lam)
            exps = torch.where(comp_active[..., None], exps, -big)
            maxexp = exps.amax(dim=1, keepdim=True)
            weighted = w[..., None] * torch.exp(exps - maxexp)
            s = weighted.sum(dim=1)  # (B, N)
            logp = torch.log(torch.clamp_min(s, tiny)) + maxexp[:, 0, :]
            ll = torch.where(point_valid, logp, 0.0).sum(dim=1)
            failed = ((s == 0.0) & point_valid).any(dim=1)
            resp = weighted / torch.clamp_min(s[:, None, :], floor)
            return ll, failed, resp

        def body(r, a, b, w, last_ll, done, failed, it, it_done):
            a_new, b_new, ok = _m_step(r, static, sigma, lam)
            a_upd = torch.where(ok & comp_active, a_new, a)
            b_upd = torch.where(ok & comp_active, b_new, b)
            nk = torch.where(point_valid[:, None, :], r, 0.0).sum(dim=2)
            w_upd = nk / n_points
            ll, ll_failed, resp = ll_and_norm(a_upd, b_upd, w_upd)
            newly_done = torch.abs(ll - last_ll) < tol
            live = ~done & ~failed
            r_next = torch.where((live & ~newly_done)[:, None, None],
                                 resp, r)
            a = torch.where(live[:, None], a_upd, a)
            b = torch.where(live[:, None], b_upd, b)
            w = torch.where(live[:, None], w_upd, w)
            last_ll = torch.where(live, ll, last_ll)
            failed = failed | (live & ll_failed)
            done = done | (live & newly_done)
            it_done = torch.where(done | failed,
                                  torch.clamp_max(it_done, it + 1), it_done)
            return r_next, a, b, w, last_ll, done, failed, it_done

        def zeros():
            return torch.zeros((B, KM), dtype=dtype, device=dev)

        r = torch.where(comp_active[..., None], r0, 0.0)
        a = zeros() if a0 is None else a0
        b = zeros() if b0 is None else b0
        w = zeros()
        ll = torch.full((B,), -big, dtype=dtype, device=dev) \
            if ll0 is None else ll0.to(dtype)
        done = torch.zeros((B,), dtype=torch.bool, device=dev)
        failed = torch.zeros((B,), dtype=torch.bool, device=dev)
        it_done = torch.full((B,), MAX_ITERS + 1, dtype=torch.int32,
                             device=dev)
        it = iters = 0
        while B and it < max_iters:
            r, a, b, w, ll, done, failed, it_done = body(
                r, a, b, w, ll, done, failed, it, it_done)
            it += 1
            iters = it
            if it % check_every == 0 or it == max_iters:
                # the iteration that finished the last row, or one past
                # this one while a row is still running
                last = int(torch.where(done | failed, it_done,
                                       it + 1).max())
                if last <= it:
                    iters = last
                    break
        return a, b, w, ll, done & ~failed, iters, r, done, failed, it_done

    return em_run


def make_em_step(sigma: float, lam: float = LAMBDA,
                 tol: float = TOLERANCE):
    """The batched EM loop for one launch over a whole batch."""
    return _build_em_run(sigma, lam, tol)


def make_em_slab_step(sigma: float, lam: float = LAMBDA,
                      tol: float = TOLERANCE):
    """Device-resident slab step for the bucketed run.

    All state stays on the device: the group's inputs are uploaded once,
    each slab is selected with a small index vector, the
    responsibility/log-likelihood/breakpoint carry is gathered and
    written back in place, and the only download is one packed
    (rows, 2K+4) result matrix: a, b, ll, done, failed, it_done.

    Gather/scatter of whole rows is exact, and every EM op is
    row-independent, so per-row trajectories are identical to a single
    uncompacted launch at the same padded shape.
    """
    em_run = _build_em_run(sigma, lam, tol)

    def slab_step(xyu, nk, carry, sel, max_iters):
        R, LL, A, Bk = carry
        a, b, _w, ll, _ok, iters, r, done, failed, it_done = em_run(
            xyu[0, sel], xyu[1, sel], xyu[2, sel], nk[0, sel], nk[1, sel],
            R[sel], LL[sel], max_iters=max_iters, a0=A[sel], b0=Bk[sel])
        R[sel] = r
        LL[sel] = ll
        A[sel] = a
        Bk[sel] = b
        packed = torch.cat(
            [a, b, ll[:, None], done[:, None].to(a.dtype),
             failed[:, None].to(a.dtype), it_done[:, None].to(a.dtype)],
            dim=1)
        return packed, iters

    return slab_step


# Iterations between straggler compactions: every SEGMENT_ITERS
# iterations the converged rows are retired on the host and only the
# stragglers are re-slabbed.  The per-iteration cost is O(K*N log N) per
# row in a slab, and a slab runs until its slowest row — without
# compaction a single 300-iteration straggler makes every converged row
# of its slab pay full fare.  Must divide MAX_ITERS.
SEGMENT_ITERS = 20

# Shape buckets: rows are grouped by (smallest K bucket >= k, smallest
# N bucket >= n) and each group is padded only to ITS bucket, not the
# global maxima.  The M-step is exactly invariant to K/N padding width
# in exact arithmetic (padding contributes only exact zeros / -BIG
# sentinels); f32 sums can drift across widths, which the hybrid
# exact-resolve margins in select_memberships already absorb.
K_BUCKETS = (3, 6, K_MAX)
N_BUCKETS_BASE = (36, 80, 144)


def _shape_buckets(width: int) -> list[int]:
    buckets = [b for b in N_BUCKETS_BASE if b < width]
    b = N_BUCKETS_BASE[-1]
    while b < width:
        b *= 2
    buckets.append(min(b, width) if b != width else width)
    buckets[-1] = min(buckets[-1], width)
    return buckets


def _bucket_of(v: int, buckets) -> int:
    for b in buckets:
        if v <= b:
            return b
    return buckets[-1]


def _torch_dtype(dtype) -> torch.dtype:
    if isinstance(dtype, torch.dtype):
        return dtype
    return {"float32": torch.float32,
            "float64": torch.float64}[np.dtype(dtype).name]


def run_em(batch: EMBatch, params: EMParams, dtype=None, device="cuda",
           chunk_rows=None):
    """Run the batched EM on ``device``.  Returns numpy ``(a, b, ll, ok)``:
    each (instance, K) row's breakpoints (rows, KMAX), its log-likelihood
    and whether it converged — the operands of ``select_memberships``.

    A CUDA device runs the program there or the call raises;
    ``device="cpu"`` runs the same code on CPU tensors.  dtype defaults to
    float64 (both have it in hardware).

    ``chunk_rows`` bounds the rows of one slab of the bucketed run
    (default: a shape group whole, on a CUDA device as many rows as its
    free memory holds); 0 runs the whole batch in one launch at its padded
    width, without buckets or compaction.
    """
    dev = require_cuda(device)
    dtype = torch.float64 if dtype is None else _torch_dtype(dtype)
    EM_RUN_STATS.clear()
    rows = len(batch.n)
    x0, y0 = np.zeros(rows), np.zeros(rows)
    if dtype == torch.float32:
        # float32 carries 24 bits and a genome coordinate takes up to 28:
        # the model depends on differences only, so each row's origin
        # moves next to its least coordinates for the device (exact in
        # float64) and back afterwards.  The origin is a multiple of 64,
        # which float32 holds exactly up to 2**30: a component that never
        # had mass starts at the old origin, minus the new one, and so
        # comes back as the 0 it is elsewhere.
        valid = np.arange(batch.x.shape[1])[None, :] < batch.n[:, None]
        x0 = np.floor(np.where(valid, batch.x, np.inf).min(axis=1) / 64) * 64
        y0 = np.floor(np.where(valid, batch.y, np.inf).min(axis=1) / 64) * 64
        batch = dataclasses.replace(
            batch, x=np.where(valid, batch.x - x0[:, None], 0.0),
            y=np.where(valid, batch.y - y0[:, None], 0.0))
    if chunk_rows != 0:
        a, b, ll, ok = _run_bucketed(params, batch, dtype, chunk_rows, dev,
                                     -x0, -y0)
    else:
        def on_device(v, dt=dtype):
            return torch.as_tensor(v, dtype=dt, device=dev)

        kmax = batch.r0.shape[1]
        outs = make_em_step(params.fragment_stddev)(
            on_device(batch.x), on_device(batch.y), on_device(batch.u),
            on_device(batch.n, None), on_device(batch.k, None),
            on_device(batch.r0),
            a0=on_device(-x0)[:, None].expand(rows, kmax),
            b0=on_device(-y0)[:, None].expand(rows, kmax))
        a, b, ll, ok = (outs[i].cpu().numpy() for i in (0, 1, 3, 4))
    if dtype == torch.float32:
        a = a.astype(np.float64) + x0[:, None]
        b = b.astype(np.float64) + y0[:, None]
    return a, b, ll, ok


def run_batch(batch: EMBatch, params: EMParams, dtype=None, device="cuda",
              chunk_rows=None, exact_resolve=None):
    """Run the batched EM (``run_em``) and select K by BIC.  Returns
    per-instance memberships: {instance_id: list of member index lists}.

    exact_resolve defaults to off for float64 and on for float32:
    instances whose decision is within the f32 drift margins are re-solved
    exactly on the host (see ``select_memberships``), making the hybrid
    output match the f64/native answer except when f32 and f64 EM
    trajectories land in different optima undetectably.
    """
    dtype = torch.float64 if dtype is None else _torch_dtype(dtype)
    a, b, ll, ok = run_em(batch, params, dtype, device, chunk_rows)
    exact = exact_resolve
    if exact is None:
        exact = dtype != torch.float64
    return select_memberships(batch, params, a, b, ll, ok,
                              exact_resolve=exact)


# (K, N)-sized tensors of the carry's type that one row of a slab holds at
# the peak of an iteration: the five event lists of the M-step, each N
# wide, times the keys, masks and temporaries alive over them.  Measured
# as peak memory over the largest slab's (rows, K, N) bytes: 39 in float64
# and 46 in float32 on an NVIDIA H100 (``chip_smoke.py``, the EM phase,
# 1,332 rows at K 10 and N 80).  A slab on a CUDA device takes at most
# SLAB_SHARE of the free memory by this count.
WORK_TENSORS = 64
SLAB_SHARE = 0.5


def _chunk_for(nb: int, kb: int, chunk_rows, itemsize: int, dev):
    """Rows of one slab of a (kb, nb) group: ``chunk_rows`` where given,
    and on a CUDA device no more than its free memory holds.  None: the
    group whole."""
    if dev.type != "cuda":
        return chunk_rows
    free, _total = torch.cuda.mem_get_info(dev)
    free += torch.cuda.memory_reserved(dev) - torch.cuda.memory_allocated(dev)
    fit = max(1, int(free * SLAB_SHARE) // (WORK_TENSORS * kb * nb * itemsize))
    return min(chunk_rows, fit) if chunk_rows else fit


# observability: per-phase attribution of the last bucketed run, filled
# by _run_bucketed (read by pipeline/discover.py's metrics and
# chip_smoke.py)
EM_RUN_STATS: dict = {}


def _run_bucketed(params: EMParams, batch: EMBatch, dtype, chunk_rows, dev,
                  a_init, b_init):
    """Bucketed + segmented + device-resident run.  ``a_init`` and
    ``b_init`` (rows,) are where each row's breakpoints start.

    Rows are grouped by (K, N) shape bucket.  Each group's inputs are
    uploaded to the device ONCE (one stacked coordinate tensor, one
    stacked n/k tensor, the seed responsibilities, and the carry); slabs
    of ``chunk`` rows are then selected by index on the device, run for
    SEGMENT_ITERS iterations, and written back into the device-resident
    carry (``make_em_slab_step``).  Converged rows are retired on the host
    from the packed results (one download a segment) and stragglers are
    re-slabbed by index — the (B, K, N) responsibility state never leaves
    the device.

    Per-row trajectories are identical to a single uncompacted launch at
    the same padded shape (row independence; gather/scatter moves whole
    rows exactly).
    """
    t_wall0 = time.time()
    stats = {"t_upload": 0.0, "t_dispatch": 0.0, "t_device_wait": 0.0,
             "t_pull": 0.0, "up_MB": 0.0, "down_MB": 0.0,
             "slabs": 0, "groups": 0, "segments": 0, "iters": 0,
             "row_iters_run": 0, "row_iters_live": 0, "slab_elems_max": 0}
    slab_step = make_em_slab_step(params.fragment_stddev)
    rows = len(batch.n)
    kmax = batch.r0.shape[1]
    np_dtype = torch.empty(0, dtype=dtype).numpy().dtype
    n_buckets = _shape_buckets(batch.x.shape[1])
    k_buckets = [min(b, kmax) for b in K_BUCKETS if b < kmax] + [kmax]

    def sync():
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)

    a_out = np.repeat(a_init[:, None].astype(np_dtype), kmax, axis=1)
    b_out = np.repeat(b_init[:, None].astype(np_dtype), kmax, axis=1)
    ll_out = np.full(rows, -BIG, np_dtype)
    ok_out = np.zeros(rows, bool)

    groups: dict[tuple[int, int], list[int]] = {}
    for i in range(rows):
        key = (_bucket_of(int(batch.k[i]), k_buckets),
               _bucket_of(int(batch.n[i]), n_buckets))
        groups.setdefault(key, []).append(i)

    n_segments = -(-MAX_ITERS // SEGMENT_ITERS)
    for (kb, nb), idx_list in sorted(groups.items()):
        idx0 = np.asarray(idx_list, np.intp)
        G = len(idx0)
        chunk = _chunk_for(nb, kb, chunk_rows, np_dtype.itemsize, dev) or G

        t0 = time.time()
        xyu = np.stack([batch.x[idx0, :nb], batch.y[idx0, :nb],
                        batch.u[idx0, :nb]]).astype(np_dtype)
        nk = np.stack([batch.n[idx0], batch.k[idx0]]).astype(np.int64)
        r_init = batch.r0[idx0][:, :kb, :nb].astype(np_dtype)
        xyu_d = torch.from_numpy(xyu).to(dev)
        nk_d = torch.from_numpy(nk).to(dev)
        carry = (torch.from_numpy(r_init).to(dev),
                 torch.full((G,), -float(BIG), dtype=dtype, device=dev),
                 *(torch.from_numpy(v[idx0].astype(np_dtype)).to(dev)[:, None]
                   .repeat(1, kb) for v in (a_init, b_init)))
        sync()
        stats["t_upload"] += time.time() - t0
        stats["up_MB"] += (xyu.nbytes + nk.nbytes + r_init.nbytes) / 1e6
        stats["groups"] += 1

        alive = np.arange(G)  # group-row positions still running
        for seg in range(n_segments):
            last = seg == n_segments - 1
            t0 = time.time()
            pending = []
            for lo in range(0, len(alive), chunk):
                sel = torch.from_numpy(alive[lo:lo + chunk]).to(dev)
                packed, iters = slab_step(xyu_d, nk_d, carry, sel,
                                          max_iters=SEGMENT_ITERS)
                pending.append(packed)
                stats["slabs"] += 1
                stats["iters"] += iters
                stats["row_iters_run"] += iters * len(sel)
                stats["slab_elems_max"] = max(stats["slab_elems_max"],
                                              len(sel) * kb * nb)
            stats["t_dispatch"] += time.time() - t0
            stats["segments"] += 1
            t0 = time.time()
            sync()
            stats["t_device_wait"] += time.time() - t0
            t0 = time.time()
            pk = torch.cat(pending).cpu().numpy()
            stats["down_MB"] += pk.nbytes / 1e6
            done = pk[:, 2 * kb + 1] > 0.5
            failed = pk[:, 2 * kb + 2] > 0.5
            stats["row_iters_live"] += int(np.minimum(
                pk[:, 2 * kb + 3], SEGMENT_ITERS).sum())
            fin = (done | failed) | last
            gi = idx0[alive[fin]]
            a_out[gi, :kb] = pk[fin, :kb]
            b_out[gi, :kb] = pk[fin, kb:2 * kb]
            ll_out[gi] = pk[fin, 2 * kb]
            ok_out[gi] = (done & ~failed)[fin]
            alive = alive[~fin]
            stats["t_pull"] += time.time() - t0
            if not len(alive):
                break
        del xyu_d, nk_d, carry
    stats["wall_s"] = round(time.time() - t_wall0, 3)
    stats["rows"] = rows
    stats["max_n"] = int(batch.n.max())
    EM_RUN_STATS.update(
        {k: (round(v, 3) if isinstance(v, float) else v)
         for k, v in stats.items()})
    return a_out, b_out, ll_out, ok_out


# ambiguity thresholds for exact_resolve: float32 trajectory drift moves
# per-point log-probabilities and instance log-likelihoods by far less
# than these margins, so decisions closer to a boundary than them are
# re-solved exactly on the host and the others are unaffected by drift of
# that size
PROB_LOG_MARGIN = 0.01
BIC_MARGIN = 0.5

# observability: filled by select_memberships on every call
LAST_SELECT_STATS: dict = {}


def select_memberships(batch: EMBatch, params: EMParams, a, b, ll, ok,
                       exact_resolve: bool = False):
    """BIC model selection + membership thresholding from per-(instance,
    K) EM results — the host tail of ``run_batch``, shared by the mesh-
    sharded EM path (``__graft_entry__.dryrun_multichip``).

    exact_resolve: hybrid device/host mode for reduced-precision (f32)
    device results.  Any instance whose decision sits within the f32
    drift margins — a non-converged/failed K row (trajectory basins can
    differ between f32 and f64), a BIC near-tie across K, or a point
    within PROB_LOG_MARGIN of the membership threshold — is re-solved
    with the exact f64 host oracle (``matepair_em.MatePairEM``, bit-
    parity with the native C++).  Everything else keeps the device
    answer, which the margins certify equal to the host's.
    """
    a = np.asarray(a)
    b = np.asarray(b)
    ll = np.asarray(ll)
    ok = np.asarray(ok)

    # BIC per (instance, k) element; argmin per instance
    bic = -2.0 * ll + batch.k * 2.0 * np.log(np.maximum(batch.n, 1))
    bic = np.where(ok, bic, np.inf)

    best: dict[int, int] = {}
    inst_rows: dict[int, list[int]] = {}
    for bi in range(len(batch.n)):
        inst = int(batch.instance[bi])
        inst_rows.setdefault(inst, []).append(bi)
        if inst not in best or bic[bi] < bic[best[inst]]:
            best[inst] = bi

    from .matepair_em import MatePairEM
    em_host = MatePairEM(params)
    minp = em_host.min_probability
    log_minp = np.log(minp)
    result: dict[int, list[list[int]]] = {}
    pending: list[tuple[int, np.ndarray, np.ndarray, np.ndarray]] = []
    for inst, bi in sorted(best.items()):
        rows = inst_rows[inst]
        n = int(batch.n[bi])
        xs = batch.x[bi, :n]
        ys = batch.y[bi, :n]
        us = batch.u[bi, :n]
        ambiguous = False
        if exact_resolve:
            if not all(ok[r] for r in rows):
                ambiguous = True
            elif len(rows) > 1:
                bics = np.sort(np.asarray([bic[r] for r in rows]))
                if np.isfinite(bics[1]) and bics[1] - bics[0] < BIC_MARGIN:
                    ambiguous = True
        if ambiguous:
            pending.append((inst, xs, ys, us))
            continue
        if not np.isfinite(bic[bi]):
            result[inst] = []
            continue
        k = int(batch.k[bi])
        clusters = []
        for j in range(k):
            prob = em_host.pair_probability(xs, ys, us, a[bi, j], b[bi, j])
            if exact_resolve and not ambiguous:
                gap = np.abs(np.log(np.maximum(prob, 1e-300)) - log_minp)
                if float(np.min(gap)) < PROB_LOG_MARGIN:
                    ambiguous = True
            members = np.nonzero(prob > minp)[0]
            if len(members) >= params.min_cluster_size:
                clusters.append(members.tolist())
        if ambiguous:
            pending.append((inst, xs, ys, us))
        else:
            result[inst] = clusters
    if pending:
        result.update(_resolve_exact(pending, params, em_host))
    LAST_SELECT_STATS.clear()
    LAST_SELECT_STATS.update(
        n_instances=len(best), n_host_resolved=len(pending),
        exact_resolve=exact_resolve)
    return result


def _resolve_exact(pending, params, em_host):
    """Exact f64 host re-solve of the drift-ambiguous instances, batched
    through the threaded native C++ solver when built (bit-identical to
    the Python oracle — the em_mode native/oracle parity contract),
    oracle fallback otherwise.  Deferring + batching matters: one Python
    re-solve an instance costs far more than the device EM it certifies."""
    from . import native
    if native.available():
        try:
            mems = native.em_cluster_batch(
                [(xs, ys, us) for _i, xs, ys, us in pending], params)
            return {inst: [list(m) for m in mm]
                    for (inst, *_), mm in zip(pending, mems)}
        except AttributeError:
            pass  # a library built before dt_em_cluster_batch: the oracle
    return {inst: [list(m) for m in em_host.do_clustering(xs, ys, us)]
            for inst, xs, ys, us in pending}
