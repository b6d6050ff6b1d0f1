"""Hartigan-Wong k-means (Applied Statistics AS 136) — exact re-implementation.

The clustering EM seeds responsibilities from AS 136 k-means
(``tools/MatePairEM.cpp:436``, algorithm in ``tools/asa136.C``).  The
algorithm is inherently sequential (point-at-a-time optimal/quick transfer
stages with incremental centre updates), so it runs host-side; instance
sizes are tiny (points per bin pair).  This implementation follows the
published AS 136 algorithm step-for-step, including the live-set
bookkeeping and the exact floating-point update order, so that cluster
seeds match the reference bit-for-bit.

Returns 0-based assignments (the Fortran original is 1-based).
"""

from __future__ import annotations

import numpy as np

_HUGE = 1.0e30


def kmns(a: np.ndarray, c: np.ndarray, iter_max: int = 1000):
    """Cluster m points (rows of ``a``, shape (m, n)) around k initial
    centres (rows of ``c``, shape (k, n), modified in place semantics not
    preserved — a copy is used).

    Returns (ic1, nc, wss, ifault):
      ic1: (m,) int 0-based cluster assignment
      nc: (k,) cluster sizes
      wss: (k,) within-cluster sums of squares
      ifault: 0 ok, 1 empty initial cluster, 2 not converged, 3 bad k
    """
    a = np.asarray(a, dtype=np.float64)
    c = np.array(c, dtype=np.float64)
    m, n = a.shape
    k = c.shape[0]

    if k <= 1 or m <= k:
        return None, None, None, 3

    ic1 = np.zeros(m, dtype=np.int64)
    ic2 = np.zeros(m, dtype=np.int64)

    # Initial assignment: nearest and second-nearest centre per point.
    for i in range(m):
        d0 = 0.0
        d1 = 0.0
        for j in range(n):
            da = a[i, j] - c[0, j]
            d0 += da * da
            da = a[i, j] - c[1, j]
            d1 += da * da
        if d1 < d0:
            ic1[i], ic2[i] = 1, 0
            d0, d1 = d1, d0
        else:
            ic1[i], ic2[i] = 0, 1
        for l in range(2, k):
            db = 0.0
            for j in range(n):
                dc = a[i, j] - c[l, j]
                db += dc * dc
            if db < d1:
                if d0 <= db:
                    d1 = db
                    ic2[i] = l
                else:
                    d1 = d0
                    ic2[i] = ic1[i]
                    d0 = db
                    ic1[i] = l

    # Centres = means of assigned points.
    nc = np.zeros(k, dtype=np.int64)
    c[:] = 0.0
    for i in range(m):
        l = ic1[i]
        nc[l] += 1
        for j in range(n):
            c[l, j] += a[i, j]
    if np.any(nc == 0):
        return None, None, None, 1
    an1 = np.zeros(k)
    an2 = np.zeros(k)
    ncp = np.zeros(k, dtype=np.int64)
    itran = np.zeros(k, dtype=np.int64)
    live = np.zeros(k, dtype=np.int64)
    d = np.zeros(m)
    for l in range(k):
        aa = float(nc[l])
        for j in range(n):
            c[l, j] /= aa
        an2[l] = aa / (aa + 1.0)
        an1[l] = aa / (aa - 1.0) if aa > 1.0 else _HUGE
        itran[l] = 1
        ncp[l] = -1

    state = {"indx": 0}
    ifault = 2

    for _ in range(iter_max):
        _optra(a, m, n, c, k, ic1, ic2, nc, an1, an2, ncp, d, itran, live,
               state)
        if state["indx"] == m:
            ifault = 0
            break
        _qtran(a, m, n, c, k, ic1, ic2, nc, an1, an2, ncp, d, itran, state)
        if k == 2:
            ifault = 0
            break
        ncp[:] = 0

    # Final wss / centres.
    wss = np.zeros(k)
    c[:] = 0.0
    for i in range(m):
        for j in range(n):
            c[ic1[i], j] += a[i, j]
    for j in range(n):
        for l in range(k):
            c[l, j] /= float(nc[l])
        for i in range(m):
            da = a[i, j] - c[ic1[i], j]
            wss[ic1[i]] += da * da

    return ic1.copy(), nc.copy(), wss, ifault


def _optra(a, m, n, c, k, ic1, ic2, nc, an1, an2, ncp, d, itran, live, state):
    # Optimal transfer stage (asa136.C optra).
    for l in range(k):
        if itran[l] == 1:
            live[l] = m + 1

    for i in range(m):  # i is 0-based; AS136's I = i+1
        state["indx"] += 1
        l1 = ic1[i]
        l2 = ic2[i]
        ll = l2

        if nc[l1] > 1:
            if ncp[l1] != 0:
                de = 0.0
                for j in range(n):
                    df = a[i, j] - c[l1, j]
                    de += df * df
                d[i] = de * an1[l1]

            da = 0.0
            for j in range(n):
                db = a[i, j] - c[l2, j]
                da += db * db
            r2 = da * an2[l2]

            for l in range(k):
                # live-set test uses 1-based point index: I < LIVE(L1)
                if (i + 1 < live[l1] or i + 1 < live[l2]) and l != l1 and l != ll:
                    rr = r2 / an2[l]
                    dc = 0.0
                    for j in range(n):
                        dd = a[i, j] - c[l, j]
                        dc += dd * dd
                    if dc < rr:
                        r2 = dc * an2[l]
                        l2 = l

            if d[i] <= r2:
                ic2[i] = l2
            else:
                state["indx"] = 0
                live[l1] = m + i + 1
                live[l2] = m + i + 1
                ncp[l1] = i + 1
                ncp[l2] = i + 1
                al1 = float(nc[l1])
                alw = al1 - 1.0
                al2 = float(nc[l2])
                alt = al2 + 1.0
                for j in range(n):
                    c[l1, j] = (c[l1, j] * al1 - a[i, j]) / alw
                    c[l2, j] = (c[l2, j] * al2 + a[i, j]) / alt
                nc[l1] -= 1
                nc[l2] += 1
                an2[l1] = alw / al1
                an1[l1] = alw / (alw - 1.0) if alw > 1.0 else _HUGE
                an1[l2] = alt / al2
                an2[l2] = alt / (alt + 1.0)
                ic1[i] = l2
                ic2[i] = l1

        if state["indx"] == m:
            return

    for l in range(k):
        itran[l] = 0
        live[l] -= m


def _qtran(a, m, n, c, k, ic1, ic2, nc, an1, an2, ncp, d, itran, state):
    # Quick transfer stage (asa136.C qtran).
    icoun = 0
    istep = 0
    while True:
        for i in range(m):
            icoun += 1
            istep += 1
            l1 = ic1[i]
            l2 = ic2[i]

            if nc[l1] > 1:
                if istep <= ncp[l1]:
                    da = 0.0
                    for j in range(n):
                        db = a[i, j] - c[l1, j]
                        da += db * db
                    d[i] = da * an1[l1]

                if istep < ncp[l1] or istep < ncp[l2]:
                    r2 = d[i] / an2[l2]
                    dd = 0.0
                    for j in range(n):
                        de = a[i, j] - c[l2, j]
                        dd += de * de
                    if dd < r2:
                        icoun = 0
                        state["indx"] = 0
                        itran[l1] = 1
                        itran[l2] = 1
                        ncp[l1] = istep + m
                        ncp[l2] = istep + m
                        al1 = float(nc[l1])
                        alw = al1 - 1.0
                        al2 = float(nc[l2])
                        alt = al2 + 1.0
                        for j in range(n):
                            c[l1, j] = (c[l1, j] * al1 - a[i, j]) / alw
                            c[l2, j] = (c[l2, j] * al2 + a[i, j]) / alt
                        nc[l1] -= 1
                        nc[l2] += 1
                        an2[l1] = alw / al1
                        an1[l1] = alw / (alw - 1.0) if alw > 1.0 else _HUGE
                        an1[l2] = alt / al2
                        an2[l2] = alt / (alt + 1.0)
                        ic1[i] = l2
                        ic2[i] = l1

            if icoun == m:
                return
