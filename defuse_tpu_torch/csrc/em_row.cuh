// Batched mate-pair EM: one (instance, K) row run to its end.
//
// The arithmetic of csrc/em.cu's em_rows_kernel (a block a row on the card)
// and of csrc/em_host.cpp (the same code built with the host's C++ compiler,
// which the CPU tests hold against the plain PyTorch loop).  Everything a
// row computes is here; what differs between the two builds is a Team: how
// a row's points and components are dealt out (a block's threads, or one
// host thread), how its threads wait for each other, and where the row's
// working arrays live.
//
// What a row computes is the plain version's body
// (cluster/matepair_em_batch.py, _build_em_run_plain), operation for
// operation in the same order and type, with one difference that is the
// point of the design: the M-step is the reference's sequential two-pointer
// merge over value runs (cluster/matepair_em.py, _EMState.max_likelihood;
// MatePairEM.cpp:192-325), walked lazily by one thread a component, in
// place of the plain version's enumeration of every event and masked
// minimum.  Its sums add one term at a time in point order (nk, the
// numerator) and in sorted order (the running sums), so they never
// decrease and stay flat across zero terms by construction, and equal sums
// pair the runs of both sides as in the reference.  Where the reference and
// the plain version differ at the edges, this follows the plain version: a
// component whose derivative never turns positive takes the path's last
// entry as a breakpoint.

#pragma once

#include <float.h>
#include <math.h>
#include <stddef.h>

#ifdef __CUDACC__
#define EM_HD __host__ __device__
#else
#define EM_HD
#endif

namespace em {

constexpr int kLanes = 32;  // the log-likelihood's partial sums

template <typename T> EM_HD inline T exp_t(T v);
template <> EM_HD inline double exp_t<double>(double v) { return exp(v); }
template <> EM_HD inline float exp_t<float>(float v) { return expf(v); }
template <typename T> EM_HD inline T log_t(T v);
template <> EM_HD inline double log_t<double>(double v) { return log(v); }
template <> EM_HD inline float log_t<float>(float v) { return logf(v); }

// torch.clamp_min / maximum / minimum: a NaN operand stays NaN
template <typename T> EM_HD inline T clamp_min(T v, T lo) {
  return v < lo ? lo : v;
}
template <typename T> EM_HD inline T max_t(T a, T b) { return a < b ? b : a; }
template <typename T> EM_HD inline T min_t(T a, T b) { return b < a ? b : a; }

// torch.finfo(T).tiny, and 1e-300 rounded to T (0 in float)
template <typename T> struct Least;
template <> struct Least<double> {
  static constexpr double tiny = DBL_MIN, floor = 1e-300;
};
template <> struct Least<float> {
  static constexpr float tiny = FLT_MIN, floor = 0.0f;
};

// A launch's constants in the carry's type.  Each is the Python float that
// the plain version multiplies or compares by, rounded to T once: sigma2
// and s2lam are products taken in double first, as Python takes them.
template <typename T> struct Consts {
  T sigma, sigma2, lam, s2lam, tol;
  T big;    // BIG: the log-likelihood of a fresh row is -big
  T floor;  // 1e-300 in T (0 in float): the responsibilities' divisor floor
  T tiny;   // the least normal T: the log's argument floor
};

template <typename T>
inline Consts<T> make_consts(double sigma, double lam, double tol) {
  return {(T)sigma, (T)(sigma * sigma), (T)lam, (T)(sigma * sigma * lam),
          (T)tol, (T)1e30, Least<T>::floor, Least<T>::tiny};
}

// The batch: x, y, u (B, N); n, k (B,); the carry r (B, KM, N), a, b (B,
// KM) and ll (B,) are read at the start and written at the end; w (B, KM),
// done, failed (B,) and it_done (B,) are written.  Only a row's first n
// points and (through w, r) its KM components are touched.
template <typename T> struct Batch {
  const T *x, *y, *u;
  const int *n, *k;
  T *r, *a, *b, *w, *ll;
  unsigned char *done, *failed;
  int *it_done;
  int B, KM, N, max_iters, never;
  Consts<T> c;
};

// One row's working arrays, carved out of one buffer: the points and their
// sorted orders (n used of N), the E-step's per-point terms, a, b and w,
// the exponents (then the weighted densities) and, where `r_inside`, the
// responsibilities; otherwise r is the carry's own row, used in place.
template <typename T> struct Row {
  T *x, *y, *u, *xs, *ys, *maxexp, *s, *logp;
  T *a, *b, *w, *slot;
  T *e, *r;
  int *xo, *yo;
  int ld;  // row stride of e and r (N)
};

EM_HD inline size_t round16(size_t v) { return (v + 15) & ~size_t(15); }

template <typename T>
EM_HD inline size_t row_bytes(int KM, int N, bool r_inside) {
  const size_t t = 8 * (size_t)N + 3 * (size_t)KM + 1 +
                   (size_t)KM * N * (r_inside ? 2 : 1);
  return round16(t * sizeof(T) + 2 * sizeof(int) * (size_t)N);
}

template <typename T>
EM_HD inline Row<T> carve(unsigned char* base, int KM, int N, T* r_carry) {
  Row<T> w;
  T* p = reinterpret_cast<T*>(base);
  w.x = p; p += N;
  w.y = p; p += N;
  w.u = p; p += N;
  w.xs = p; p += N;
  w.ys = p; p += N;
  w.maxexp = p; p += N;
  w.s = p; p += N;
  w.logp = p; p += N;
  w.a = p; p += KM;
  w.b = p; p += KM;
  w.w = p; p += KM;
  w.slot = p; p += 1;
  w.e = p; p += (size_t)KM * N;
  if (r_carry) {
    w.r = r_carry;
  } else {
    w.r = p; p += (size_t)KM * N;
  }
  w.xo = reinterpret_cast<int*>(p);
  w.yo = w.xo + N;
  w.ld = N;
  return w;
}

// Descending x and descending y, stable, as the plain version's argsort of
// -x: the rank of point i counts the points above it and the equal ones
// before it.  O(n^2) a row, once a launch.
template <typename T, typename Team>
EM_HD void sort_points(const Team& team, Row<T>& w, int n) {
  for (int i = team.rank(); i < n; i += team.size()) {
    const T xi = w.x[i], yi = w.y[i];
    int rx = 0, ry = 0;
    for (int j = 0; j < n; ++j) {
      rx += (w.x[j] > xi) || (w.x[j] == xi && j < i);
      ry += (w.y[j] > yi) || (w.y[j] == yi && j < i);
    }
    w.xs[rx] = xi;
    w.xo[rx] = i;
    w.ys[ry] = yi;
    w.yo[ry] = i;
  }
}

// The last two entries of the merge path walked so far; step() appends one
// and says whether the likelihood's derivative there is positive.
template <typename T> struct Path {
  T rxyu, nk, cx, cy, cs, px, py, ps;
  int count;

  EM_HD bool step(T x, T y, T sum, const Consts<T>& c) {
    px = cx; py = cy; ps = cs;
    cx = x; cy = y; cs = sum;
    ++count;
    return (rxyu - nk * (x + y)) / c.sigma2 + c.lam * sum > T(0);
  }
};

// The exact M-step of one component: its responsibilities r (the row's
// first n points).  Returns nk; a and b move only where nk > 0.
template <typename T>
EM_HD T m_step(const T* r, const Row<T>& w, int n, const Consts<T>& c, T& a,
               T& b) {
  T nk = T(0), rxyu = T(0);
  for (int i = 0; i < n; ++i) {
    nk = nk + r[i];
    rxyu = rxyu + r[i] * ((w.x[i] + w.y[i]) + w.u[i]);
  }
  if (!(nk > T(0))) return nk;
  Path<T> p = {rxyu, nk, T(0), T(0), T(0), T(0), T(0), T(0), 0};
  bool rising = p.step(w.xs[0], w.ys[0], T(0), c);
  int i = 0, j = 0;
  T sx = r[w.xo[0]], sy = r[w.yo[0]];
  while (!rising && i < n && j < n) {
    if (i + 1 < n && w.xs[i] == w.xs[i + 1]) {  // inside an x run
      ++i;
      sx = sx + r[w.xo[i]];
      continue;
    }
    if (j + 1 < n && w.ys[j] == w.ys[j + 1]) {  // inside a y run
      ++j;
      sy = sy + r[w.yo[j]];
      continue;
    }
    if (sx == sy) {  // both runs end at one sum: advance both
      rising = p.step(w.xs[i], w.ys[j], sx, c);
      if (!rising && i + 1 < n && j + 1 < n)
        rising = p.step(w.xs[i + 1], w.ys[j + 1], sx, c);
      if (++i < n) sx = sx + r[w.xo[i]];
      if (++j < n) sy = sy + r[w.yo[j]];
    } else if (sx < sy) {
      rising = p.step(w.xs[i], w.ys[j], sx, c);
      if (!rising && i + 1 < n) rising = p.step(w.xs[i + 1], w.ys[j], sx, c);
      if (++i < n) sx = sx + r[w.xo[i]];
    } else {
      rising = p.step(w.xs[i], w.ys[j], sy, c);
      if (!rising && j + 1 < n) rising = p.step(w.xs[i], w.ys[j + 1], sy, c);
      if (++j < n) sy = sy + r[w.yo[j]];
    }
  }
  const T aplusb = (rxyu + c.s2lam * p.cs) / nk;
  if (rising && p.count == 1) {  // the first entry already rises
    a = T(0.5) * (p.cx + (aplusb - p.cy));
    b = aplusb - a;
  } else if (!rising || p.cs != p.ps) {  // a corner, or the path's end
    a = p.cx;
    b = p.cy;
  } else {  // a flat stretch between the last two entries
    a = T(0.5) * (max_t(p.cx, aplusb - p.py) + min_t(p.px, aplusb - p.cy));
    b = aplusb - a;
  }
  return nk;
}

template <typename T>
EM_HD inline T exponent(T a, T b, T x, T y, T u, const Consts<T>& c) {
  const T diff = ((((a + b) - x) - y) - u) / c.sigma;
  return ((T(-0.5) * diff) * diff - c.lam * clamp_min(x - a, T(0))) -
         c.lam * clamp_min(y - b, T(0));
}

// E-step, first pass, point i: the exponents, their maximum, the weighted
// densities (left in e), their sum and the point's log-probability.
// Returns whether the point has no mass.
template <typename T>
EM_HD bool e_point(Row<T>& w, int i, int k, const Consts<T>& c) {
  const T x = w.x[i], y = w.y[i], u = w.u[i];
  T m = -c.big;
  for (int j = 0; j < k; ++j) {
    const T e = exponent(w.a[j], w.b[j], x, y, u, c);
    w.e[j * w.ld + i] = e;
    if (e > m) m = e;
  }
  T s = T(0);
  for (int j = 0; j < k; ++j) {
    const T weighted = w.w[j] * exp_t(w.e[j * w.ld + i] - m);
    w.e[j * w.ld + i] = weighted;
    s = s + weighted;
  }
  w.maxexp[i] = m;
  w.s[i] = s;
  w.logp[i] = log_t(clamp_min(s, c.tiny)) + m;
  return s == T(0);
}

// E-step, second pass, point i: the responsibilities of every component
// (0 over the divisor for those past k, which is NaN where it is 0).
template <typename T>
EM_HD void resp_point(Row<T>& w, int i, int k, int KM, const Consts<T>& c) {
  const T d = clamp_min(w.s[i], c.floor);
  for (int j = 0; j < k; ++j) w.r[j * w.ld + i] = w.e[j * w.ld + i] / d;
  for (int j = k; j < KM; ++j) w.r[j * w.ld + i] = T(0) / d;
}

// The row's EM from its carry to convergence, failure or max_iters.  A
// Team gives rank(), size(), sync(), any(flag) (a barrier that ORs flags)
// and ll_sum(v, n, slot): the sum of v[0..n) in one fixed order, the same
// on every Team.
template <typename T, typename Team>
EM_HD void run_row(const Team& team, Row<T>& w, int n, int k, int KM,
                   const Consts<T>& c, int max_iters, int never, T& last_ll,
                   bool& done, bool& failed, int& it_done) {
  sort_points(team, w, n);
  team.sync();
  const T n_points = T(n > 1 ? n : 1);
  done = failed = false;
  it_done = never;
  for (int it = 0; it < max_iters; ++it) {
    for (int j = team.rank(); j < KM; j += team.size()) {
      const T nk = j < k ? m_step(w.r + j * w.ld, w, n, c, w.a[j], w.b[j])
                         : T(0);
      w.w[j] = nk / n_points;
    }
    team.sync();
    bool empty = false;
    for (int i = team.rank(); i < n; i += team.size())
      empty = e_point(w, i, k, c) || empty;
    failed = team.any(empty);
    const T ll = team.ll_sum(w.logp, n, w.slot);
    const T change = ll - last_ll;
    done = (change < T(0) ? -change : change) < c.tol;
    if (!done) {
      for (int i = team.rank(); i < n; i += team.size())
        resp_point(w, i, k, KM, c);
      team.sync();
    }
    last_ll = ll;
    if (done || failed) {
      it_done = it + 1 < never ? it + 1 : never;
      break;
    }
  }
}

// One row of the batch, start to end: the carry into the row's arrays
// (`base`; r stays in the carry unless r_inside), the EM, and back.
template <typename T, typename Team>
EM_HD void process_row(const Team& team, const Batch<T>& p, int row,
                       unsigned char* base, bool r_inside) {
  const int KM = p.KM, N = p.N, n = p.n[row], k = p.k[row];
  const size_t at = (size_t)row * N, at_k = (size_t)row * KM;
  T* r_row = p.r + at_k * N;
  Row<T> w = carve<T>(base, KM, N, r_inside ? nullptr : r_row);
  for (int i = team.rank(); i < n; i += team.size()) {
    w.x[i] = p.x[at + i];
    w.y[i] = p.y[at + i];
    w.u[i] = p.u[at + i];
  }
  for (int j = team.rank(); j < KM; j += team.size()) {
    w.a[j] = p.a[at_k + j];
    w.b[j] = p.b[at_k + j];
    w.w[j] = T(0);
  }
  if (r_inside)
    for (int q = team.rank(); q < KM * n; q += team.size())
      w.r[(q / n) * N + q % n] = r_row[(q / n) * N + q % n];
  team.sync();
  T ll = p.ll[row];
  bool done, failed;
  int it_done;
  run_row(team, w, n, k, KM, p.c, p.max_iters, p.never, ll, done, failed,
          it_done);
  team.sync();
  for (int j = team.rank(); j < KM; j += team.size()) {
    p.a[at_k + j] = w.a[j];
    p.b[at_k + j] = w.b[j];
    p.w[at_k + j] = w.w[j];
  }
  if (r_inside)
    for (int q = team.rank(); q < KM * n; q += team.size())
      r_row[(q / n) * N + q % n] = w.r[(q / n) * N + q % n];
  if (team.rank() == 0) {
    p.ll[row] = ll;
    p.done[row] = done;
    p.failed[row] = failed;
    p.it_done[row] = it_done;
  }
}

// The host's Team: one thread, and the card's order for the
// log-likelihood (kLanes strided partial sums, then a halving tree).
struct HostTeam {
  int rank() const { return 0; }
  int size() const { return 1; }
  void sync() const {}
  bool any(bool v) const { return v; }

  template <typename T> T ll_sum(const T* v, int n, T*) const {
    T part[kLanes];
    for (int l = 0; l < kLanes; ++l) {
      part[l] = T(0);
      for (int i = l; i < n; i += kLanes) part[l] = part[l] + v[i];
    }
    for (int off = kLanes / 2; off > 0; off /= 2)
      for (int l = 0; l < off; ++l) part[l] = part[l] + part[l + off];
    return part[0];
  }
};

}  // namespace em
