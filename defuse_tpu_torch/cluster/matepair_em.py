"""Mate-pair clustering EM — exact oracle implementation.

Re-implements the reference's 2-D mixture EM over breakpoint positions
(``tools/MatePairEM.cpp``) with bit-matching float64 semantics:

* component (a_j, b_j) likelihood for pair i:
  ``N(a+b-x-y-u; 0, sigma) * exp(-lambda*max(0,x-a) - lambda*max(0,y-b))``
  (``MatePairEM.cpp:91-94,108``)
* exact M-step: 1-D piecewise-linear maximization over merged sorted
  partial-sum breakpoints (``MatePairEM.cpp:192-325``)
* init: KKZ farthest-point seeding + AS 136 k-means
  (``MatePairEM.cpp:327-386,436``)
* model selection K=1..10 by BIC (``MatePairEM.cpp:588-607``)
* membership: pair probability above a precision-derived threshold
  (``MatePairEM.cpp:49-50,617-635``)

Sequential reductions in the C++ (std::accumulate / partial_sum) are
reproduced with ``np.cumsum`` (strict left-to-right f64) so log-likelihood
trajectories match bit-for-bit.  The descending sorts of x and y use a
stable tie order (original index); the C++ ``std::sort`` is unstable but
instance sizes below libstdc++'s introsort threshold (16) are insertion
sorted, which is stable — larger instances may order exact ties
differently, which affects nothing downstream because tied coordinates
produce identical partial-sum breakpoints.

This oracle is the parity ground truth; ``matepair_em_batch.py`` holds the
batched JAX version used on TPU, validated against this one.
"""

from __future__ import annotations

import dataclasses
import math

import numpy as np

from ..stats.normal import em_min_probability, normpdf
from .kmeans import kmns

K_MAX = 10
LAMBDA = 0.1
TOLERANCE = 0.001
KMEANS_ITER = 1000
_DBL_MAX = np.finfo(np.float64).max


def _seq_sum(values: np.ndarray) -> float:
    """Strict left-to-right f64 sum (std::accumulate order)."""
    if len(values) == 0:
        return 0.0
    return float(np.cumsum(values)[-1])


@dataclasses.dataclass
class EMParams:
    fragment_mean: float
    fragment_stddev: float
    precision: float
    min_cluster_size: int

    @property
    def min_probability(self) -> float:
        return em_min_probability(self.precision, self.fragment_stddev)

    @property
    def max_fragment_length(self) -> float:
        # MatePairEM.cpp:52
        return self.fragment_mean + 3 * self.fragment_stddev


def strand_remap(start: int, end: int, strand: int):
    """Region → strand space (``MatePairEM.cpp:75-83``)."""
    if strand == 0:
        return start, end
    return -end, -start


def calc_break_region(start: int, end: int, strand: int, params: EMParams):
    """Break region for one alignment (``MatePairEM.cpp:67-89``)."""
    rs, re = strand_remap(start, end, strand)
    bs = re + 1
    be = 2 * rs - re - 2 + int(params.max_fragment_length)
    # remap back
    os_, oe = strand_remap(bs, be, strand)
    return os_, oe


class MatePairEM:
    """Exact mate-pair EM for a single bin-pair instance."""

    def __init__(self, params: EMParams):
        self.p = params
        self.min_probability = params.min_probability

    def do_clustering(self, x, y, u):
        """Cluster mate pairs given remapped coordinates.

        x[i], y[i]: strand-remapped 3' alignment ends of the two reads
        u[i]: fragment_mean - len1 - len2
        Returns a list of clusters, each a list of pair indices
        (``MatePairEM.cpp:540-636``).
        """
        n = len(x)
        if n < self.p.min_cluster_size:
            return []

        x = np.asarray(x, dtype=np.float64)
        y = np.asarray(y, dtype=np.float64)
        u = np.asarray(u, dtype=np.float64)

        # Descending sorts with stable tie order (see module docstring).
        xo_order = np.argsort(-x, kind="stable")
        yo_order = np.argsort(-y, kind="stable")
        xo = x[xo_order]
        yo = y[yo_order]
        to_xo = np.empty(n, dtype=np.int64)
        to_xo[xo_order] = np.arange(n)
        to_yo = np.empty(n, dtype=np.int64)
        to_yo[yo_order] = np.arange(n)

        state = _EMState(self, x, y, u, xo, yo, to_xo, to_yo)

        min_bic = None
        k_min_bic = 1
        for k in range(1, min(K_MAX, n) + 1):
            ok, ll = state.expectation_maximization(k)
            if not ok:
                continue
            bic = -2.0 * ll + k * 2.0 * math.log(n)
            if min_bic is None or bic < min_bic:
                min_bic = bic
                k_min_bic = k

        ok, _ = state.expectation_maximization(k_min_bic)
        if not ok:
            return []

        clusters = []
        for j in range(k_min_bic):
            prob = self.pair_probability(x, y, u, state.a[j], state.b[j])
            members = np.nonzero(prob > self.min_probability)[0]
            if len(members) >= self.p.min_cluster_size:
                clusters.append(members.tolist())
        return clusters

    def pair_probability(self, x, y, u, a, b):
        """Vectorized PairProbability (``MatePairEM.cpp:91-94``)."""
        sigma = self.p.fragment_stddev
        coeff = 1.0 / (sigma * math.sqrt(2.0 * math.pi))
        dist = (a + b - x - y - u) / sigma
        gauss = coeff * np.exp(-0.5 * dist * dist)
        decay = np.exp(-LAMBDA * np.maximum(0.0, x - a)
                       - LAMBDA * np.maximum(0.0, y - b))
        return gauss * decay


class _EMState:
    def __init__(self, em: MatePairEM, x, y, u, xo, yo, to_xo, to_yo):
        self.em = em
        self.x, self.y, self.u = x, y, u
        self.xo, self.yo = xo, yo
        self.to_xo, self.to_yo = to_xo, to_yo
        self.n = len(x)
        self.a = None
        self.b = None
        self.w = None

    def _exponents(self):
        # exponents[j,i]  (MatePairEM.cpp:104-110)
        sigma = self.em.p.fragment_stddev
        diff = (self.a[:, None] + self.b[:, None]
                - self.x[None, :] - self.y[None, :] - self.u[None, :]) / sigma
        return (-0.5 * diff * diff
                - LAMBDA * np.maximum(0.0, self.x[None, :] - self.a[:, None])
                - LAMBDA * np.maximum(0.0, self.y[None, :] - self.b[:, None]))

    def _weighted_mix(self, exponents):
        # per-i: maxexp over j, then sequential-over-j sum of w_j*exp(...)
        maxexp = exponents[0].copy()
        for j in range(1, exponents.shape[0]):
            maxexp = np.maximum(maxexp, exponents[j])
        s = np.zeros(self.n)
        for j in range(exponents.shape[0]):
            s = s + self.w[j] * np.exp(exponents[j] - maxexp)
        return maxexp, s

    def log_likelihood(self) -> float:
        exponents = self._exponents()
        maxexp, s = self._weighted_mix(exponents)
        if np.any(s == 0.0):
            # first zero encountered aborts the accumulation (MatePairEM.cpp:127-131)
            return -_DBL_MAX
        return _seq_sum(np.log(s) + maxexp)

    def update_responsibilities(self):
        exponents = self._exponents()
        maxexp, norm = self._weighted_mix(exponents)
        k = exponents.shape[0]
        for j in range(k):
            r = self.w[j] * np.exp(exponents[j] - maxexp) / norm
            self.r[j] = r
            self.rxo[j] = r[self.xo_inv_order]
            self.ryo[j] = r[self.yo_inv_order]

    @property
    def xo_inv_order(self):
        # index i of the point at sorted position s:  rxo[to_xo[i]] = r[i]
        return self._xo_inv

    @property
    def yo_inv_order(self):
        return self._yo_inv

    def _prepare_orders(self):
        n = self.n
        self._xo_inv = np.empty(n, dtype=np.int64)
        self._xo_inv[self.to_xo] = np.arange(n)
        self._yo_inv = np.empty(n, dtype=np.int64)
        self._yo_inv[self.to_yo] = np.arange(n)

    def max_likelihood(self, r, rxo, ryo):
        """Exact M-step for one component (``MatePairEM.cpp:192-325``).

        Returns (ok, a, b).
        """
        n = self.n
        sigma = self.em.p.fragment_stddev
        sx = np.cumsum(rxo)
        sy = np.cumsum(ryo)
        xo, yo = self.xo, self.yo

        cx = [xo[0]]
        cy = [yo[0]]
        cs = [0.0]
        i = 0
        j = 0
        while i < n and j < n:
            if i + 1 < n and xo[i] == xo[i + 1]:
                i += 1
                continue
            if j + 1 < n and yo[j] == yo[j + 1]:
                j += 1
                continue
            if sx[i] == sy[j]:
                cx.append(xo[i]); cy.append(yo[j]); cs.append(sx[i])
                if i + 1 < n and j + 1 < n:
                    cx.append(xo[i + 1]); cy.append(yo[j + 1]); cs.append(sx[i])
                i += 1
                j += 1
            elif sx[i] < sy[j]:
                cx.append(xo[i]); cy.append(yo[j]); cs.append(sx[i])
                if i + 1 < n:
                    cx.append(xo[i + 1]); cy.append(yo[j]); cs.append(sx[i])
                i += 1
            else:
                cx.append(xo[i]); cy.append(yo[j]); cs.append(sy[j])
                if j + 1 < n:
                    cx.append(xo[i]); cy.append(yo[j + 1]); cs.append(sy[j])
                j += 1

        nk = _seq_sum(r)
        if nk == 0.0:
            return False, 0.0, 0.0

        rxyu = _seq_sum(r * (self.x + self.y + self.u))

        cx = np.asarray(cx)
        cy = np.asarray(cy)
        cs = np.asarray(cs)
        partial = (rxyu - nk * (cx + cy)) / (sigma * sigma) + LAMBDA * cs

        pos = np.nonzero(partial > 0)[0]
        minindex = int(pos[0]) if len(pos) else len(partial)
        if minindex >= len(partial):
            # C++ reads CS[minindex] past the vector in this case only if the
            # whole derivative is <= 0; the loop leaves minindex == size and
            # the subsequent access is UB.  In practice the derivative's last
            # entry is positive (lambda*CS grows); guard anyway.
            minindex = len(partial) - 1

        aplusb = (rxyu + sigma * sigma * LAMBDA * cs[minindex]) / nk

        if minindex == 0:
            min_a = cx[0]
            max_a = aplusb - cy[0]
            a = 0.5 * (min_a + max_a)
            b = aplusb - a
        elif cs[minindex] != cs[minindex - 1]:
            a = cx[minindex]
            b = cy[minindex]
        else:
            min_a = max(cx[minindex], aplusb - cy[minindex - 1])
            max_a = min(cx[minindex - 1], aplusb - cy[minindex])
            a = 0.5 * (min_a + max_a)
            b = aplusb - a
        return True, float(a), float(b)

    def select_kkz(self, k):
        """KKZ seeding (``MatePairEM.cpp:327-386``)."""
        x, y = self.x, self.y
        l2 = x * y
        # strict > : first max wins
        i_max = 0
        l2max = l2[0]
        for i in range(1, self.n):
            if l2[i] > l2max:
                i_max = i
                l2max = l2[i]
        ax = [x[i_max]]
        ay = [y[i_max]]
        dist_min = (x - ax[0]) ** 2 + (y - ay[0]) ** 2
        while len(ax) < k:
            i_far = 0
            far = dist_min[0]
            for i in range(1, self.n):
                if dist_min[i] > far:
                    far = dist_min[i]
                    i_far = i
            if far == 0.0:
                return None, None
            ax.append(x[i_far])
            ay.append(y[i_far])
            dist_min = np.minimum(dist_min,
                                  (x - ax[-1]) ** 2 + (y - ay[-1]) ** 2)
        return np.asarray(ax), np.asarray(ay)

    def expectation_maximization(self, k):
        """One full EM run at fixed K (``MatePairEM.cpp:388-494``)."""
        n = self.n
        self._prepare_orders()
        self.r = np.zeros((k, n))
        self.rxo = np.zeros((k, n))
        self.ryo = np.zeros((k, n))
        self.w = np.zeros(k)
        if self.a is None or len(self.a) != k:
            self.a = np.zeros(k)
            self.b = np.zeros(k)
        else:
            self.a = np.zeros(k)
            self.b = np.zeros(k)

        if k == 1 or k == n:
            self.r[:] = 1.0 / k
            self.rxo[:] = 1.0 / k
            self.ryo[:] = 1.0 / k
        else:
            px, py = self.select_kkz(k)
            if px is None:
                return False, 0.0
            # kmns over (y, x) column layout (MatePairEM.cpp:423-436)
            a_mat = np.stack([self.y, self.x], axis=1)
            c_mat = np.stack([py, px], axis=1)
            ic1, _, _, ifault = kmns(a_mat, c_mat, KMEANS_ITER)
            if ifault in (1, 3):
                raise AssertionError(f"kmns ifault={ifault}")
            onehot = np.zeros((k, n))
            onehot[ic1, np.arange(n)] = 1.0
            self.r = onehot
            for j in range(k):
                self.rxo[j] = self.r[j][self._xo_inv]
                self.ryo[j] = self.r[j][self._yo_inv]

        last_ll = None
        while True:
            for j in range(k):
                ok, a, b = self.max_likelihood(self.r[j], self.rxo[j],
                                               self.ryo[j])
                if ok:
                    self.a[j] = a
                    self.b[j] = b

            # UpdateMixWeights (MatePairEM.cpp:183-190)
            for j in range(k):
                self.w[j] = _seq_sum(self.r[j]) / n

            ll = self.log_likelihood()
            if last_ll is not None and abs(ll - last_ll) < TOLERANCE:
                break
            if last_ll is not None and ll == -_DBL_MAX:
                return False, 0.0
            last_ll = ll
            self.update_responsibilities()

        return True, last_ll
