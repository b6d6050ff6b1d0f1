// Batched mate-pair EM: one (instance, K) row run to its end.
//
// The arithmetic of csrc/em.cu's em_rows_kernel (a block a row on the card)
// and of csrc/em_host.cpp (the same code built with the host's C++ compiler,
// which the CPU tests hold against the plain PyTorch loop).  Everything a
// row computes is here; what differs between the two builds is a Team: how
// a row's points and components are dealt out (a block's threads and warps,
// or one host thread that plays a warp's lanes in a loop), how its threads
// wait for each other, and where the row's working arrays live.
//
// What a row computes is the plain version's body
// (cluster/matepair_em_batch.py, _build_em_run_plain), operation for
// operation in the same order and type, with one difference that is the
// point of the design: the M-step is the reference's sequential two-pointer
// merge over value runs (cluster/matepair_em.py, _EMState.max_likelihood;
// MatePairEM.cpp:192-325), stopped at its first rising entry, in place of
// the plain version's enumeration of every event and masked minimum.  Its
// sums add one term at a time in point order (nk, the numerator) and in
// sorted order (the running sums), so they never decrease and stay flat
// across zero terms by construction, and equal sums pair the runs of both
// sides as in the reference.  Where the reference and the plain version
// differ at the edges, this follows the plain version: a component whose
// derivative never turns positive takes the path's last entry as a
// breakpoint.
//
// Two forms of that M-step, the same bits:
//  * m_step_walk: one thread walks a component's merge lazily, each step
//    waiting on the last's running sum, division and compare.  The
//    reference the other is held to (em_host.cpp's walk entry, em.cu's
//    check entry); no row of the main path runs it.
//  * m_sums + m_step_warp: the sums first, folded in the walk's order, two
//    threads a component side by side (nk and the numerator in point
//    order, the running sums in both sorted orders, kept at each value
//    run's end); then a warp a component places the path's steps a
//    diagonal a lane, kLanes at a time (a binary search over those sums,
//    as a merge path's), and tests their entries on its lanes at once;
//    ballots find the first rising one.  Each entry carries the sums the
//    walk would carry there, folded in the same order, so the first rising
//    entry, and the breakpoint, are the walk's.

#pragma once

#include <float.h>
#include <math.h>
#include <stddef.h>

#ifdef __CUDACC__
#define EM_HD __host__ __device__
#define EM_UNROLL _Pragma("unroll")
#else
#define EM_HD
#define EM_UNROLL
#endif

namespace em {

// a warp's lanes: the log-likelihood's partial sums, and the path entries
// the M-step tests at once
constexpr int kLanes = 32;

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
// For the M-step: the value runs of both sorted orders; each component's
// running sums at its x-run ends (in e, which the E-step rewrites before
// it reads it) and y-run ends (sy), with their ranks among equal sums
// before them (xrk, yrk), its nk and numerator (sums); and a chunk of
// path steps for each of the block's `warps` warps.
template <typename T> struct Row {
  T *x, *y, *u, *xs, *ys, *maxexp, *s, *logp;
  T *a, *b, *w, *slot;
  T *e, *r, *sy, *sums, *chunk;
  int *xo, *yo;
  int *xrun, *yrun;  // a sorted position's run, where the run ends there; -1
  int *xe, *ye;      // each run's last sorted position
  int *runs;         // the runs of x and of y
  int *xrk, *yrk, *chunk_int;
  int ld;  // row stride of e, r, sy, xrk and yrk (N)
};

// The T and int words of a warp's chunk: kLanes path steps, each with two
// entries of (x, y, sum), whether its second entry exists and its x runs.
constexpr int kChunkT = 6 * kLanes, kChunkInt = 2 * kLanes;

EM_HD inline size_t round16(size_t v) { return (v + 15) & ~size_t(15); }

template <typename T>
EM_HD inline size_t row_bytes(int KM, int N, int warps, bool r_inside) {
  const size_t t = 8 * (size_t)N + 5 * (size_t)KM + 1 +
                   (size_t)KM * N * (r_inside ? 3 : 2) +
                   (size_t)kChunkT * warps;
  const size_t i = 6 * (size_t)N + 2 + 2 * (size_t)KM * N +
                   (size_t)kChunkInt * warps;
  return round16(t * sizeof(T) + sizeof(int) * i);
}

template <typename T>
EM_HD inline Row<T> carve(unsigned char* base, int KM, int N, int warps,
                          T* r_carry) {
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
  w.sy = p; p += (size_t)KM * N;
  w.sums = p; p += 2 * (size_t)KM;
  w.chunk = p; p += (size_t)kChunkT * warps;
  w.xo = reinterpret_cast<int*>(p);
  w.yo = w.xo + N;
  w.xrun = w.yo + N;
  w.yrun = w.xrun + N;
  w.xe = w.yrun + N;
  w.ye = w.xe + N;
  w.runs = w.ye + N;
  w.xrk = w.runs + 2;
  w.yrk = w.xrk + (size_t)KM * N;
  w.chunk_int = w.yrk + (size_t)KM * N;
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

// The value runs of both sorted orders, once a launch after the sort: each
// run's last position (xe, ye), the run of each position where a run ends
// (xrun, yrun; -1 inside a run) and the count of runs.  A run is the walk's:
// neighbours that compare equal.
template <typename T, typename Team>
EM_HD void mark_runs(const Team& team, Row<T>& w, int n) {
  for (int side = team.rank(); side < 2; side += team.size()) {
    const T* v = side ? w.ys : w.xs;
    int* run = side ? w.yrun : w.xrun;
    int* end = side ? w.ye : w.xe;
    int count = 0;
    for (int q = 0; q < n; ++q) {
      const bool last = q + 1 == n || !(v[q] == v[q + 1]);
      run[q] = last ? count : -1;
      if (last) end[count++] = q;
    }
    w.runs[side] = count;
  }
}

// Whether the likelihood's derivative is positive at the merge path's
// entry (x, y, sum) of a component with sums rxyu and nk.
template <typename T>
EM_HD inline bool rises(T rxyu, T nk, T x, T y, T sum, const Consts<T>& c) {
  return (rxyu - nk * (x + y)) / c.sigma2 + c.lam * sum > T(0);
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
    return rises(rxyu, nk, x, y, sum, c);
  }

  // The breakpoint where the path stops: at its first rising entry, or
  // (not rising) at its end.
  EM_HD void breakpoint(bool rising, const Consts<T>& c, T& a, T& b) const {
    const T aplusb = (rxyu + c.s2lam * cs) / nk;
    if (rising && count == 1) {  // the first entry already rises
      a = T(0.5) * (cx + (aplusb - cy));
      b = aplusb - a;
    } else if (!rising || cs != ps) {  // a corner, or the path's end
      a = cx;
      b = cy;
    } else {  // a flat stretch between the last two entries
      a = T(0.5) * (max_t(cx, aplusb - py) + min_t(px, aplusb - cy));
      b = aplusb - a;
    }
  }
};

// The exact M-step of one component, walked by one thread: its
// responsibilities r (the row's first n points).  Returns nk; a and b move
// only where nk > 0.
template <typename T>
EM_HD T m_step_walk(const T* r, const Row<T>& w, int n, const Consts<T>& c,
                    T& a, T& b) {
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
  p.breakpoint(rising, c, a, b);
  return nk;
}

// The M-step's sums of the row's first k components, two threads a
// component, each folding two sums one term at a time: over points
// 0..n-1, nk (side 0) or the numerator rxyu (side 1) into sums, as
// m_step_walk adds them; and the running sum in x-sorted (side 0, into e)
// or y-sorted order (side 1, into sy), the walk's sx or sy, kept where a
// run ends, with its rank among the equal sums before it (xrk, yrk).  Both
// sides run the same code (side 0's point term is r times 1, exactly r),
// so a warp's lanes do not diverge, and nothing branches on a term:
// kAhead terms and their runs are loaded before any is added, so only the
// adds wait on the last, and each term stores the last run end's sum and
// rank again where no run ends at it.
template <typename T, typename Team>
EM_HD void m_sums(const Team& team, Row<T>& w, int n, int k) {
  constexpr int kAhead = 4;
  for (int t = team.rank(); t < 2 * k; t += team.size()) {
    const int j = t >> 1, side = t & 1;
    const T* r = w.r + j * w.ld;
    const int* order = side ? w.yo : w.xo;
    const int* run = side ? w.yrun : w.xrun;
    T* at_ends = (side ? w.sy : w.e) + j * w.ld;
    int* ranks = (side ? w.yrk : w.xrk) + j * w.ld;
    T point = T(0), sorted = T(0), last = T(0);
    int rank = 0, slot = 0;  // the last run end's rank and run
    for (int q0 = 0; q0 < n; q0 += kAhead) {
      T pt[kAhead], st[kAhead];
      int at[kAhead];  // the run that ends at the term, else -1
      EM_UNROLL
      for (int d = 0; d < kAhead; ++d) {
        const int q = q0 + d < n ? q0 + d : n - 1;
        const T f = side ? (w.x[q] + w.y[q]) + w.u[q] : T(1);
        pt[d] = r[q] * f;
        st[d] = r[order[q]];
        at[d] = run[q];
      }
      EM_UNROLL
      for (int d = 0; d < kAhead; ++d) {
        if (q0 + d >= n) break;
        point = point + pt[d];
        sorted = q0 + d == 0 ? st[d] : sorted + st[d];
        const bool end = at[d] >= 0;
        rank = end ? (at[d] > 0 && sorted == last ? rank + 1 : 0) : rank;
        last = end ? sorted : last;
        slot = end ? at[d] : slot;
        at_ends[slot] = last;
        ranks[slot] = rank;
      }
    }
    w.sums[2 * j + side] = point;
  }
}

EM_HD inline int lowest_lane(unsigned mask) {
#ifdef __CUDA_ARCH__
  return __ffs(mask) - 1;
#else
  return __builtin_ctz(mask);
#endif
}

EM_HD inline int highest_lane(unsigned mask) {
#ifdef __CUDA_ARCH__
  return 31 - __clz(mask);
#else
  return 31 - __builtin_clz(mask);
#endif
}

// One entry of the merge path.
template <typename T> struct Entry {
  T x, y, sum;
};

// A warp's chunk of kLanes path steps, one a lane: each step's first entry
// (x1, y1, s1) and, where two, its second; and the x runs before its state
// (ra).
template <typename T> struct Chunk {
  T *x1, *y1, *s1, *x2, *y2, *s2;
  int *two, *ra;

  EM_HD Entry<T> first(int l) const { return {x1[l], y1[l], s1[l]}; }
  EM_HD Entry<T> second(int l) const { return {x2[l], y2[l], s2[l]}; }
  EM_HD Entry<T> last(int l) const { return two[l] ? second(l) : first(l); }
};

template <typename T> EM_HD Chunk<T> chunk_of(const Row<T>& w, int warp) {
  T* p = w.chunk + (size_t)kChunkT * warp;
  int* q = w.chunk_int + (size_t)kChunkInt * warp;
  return {p, p + kLanes, p + 2 * kLanes, p + 3 * kLanes, p + 4 * kLanes,
          p + 5 * kLanes, q, q + kLanes};
}

// What path_step says of a lane's diagonal.
enum : unsigned { kHasStep = 1, kFirstRises = 2, kSecondRises = 4 };

// The walk's merge of component j, in value runs: its state (ra, rb)
// advances ra, rb or both at each step, so a step's state lies on the
// diagonal ra + rb = d, and no two steps share one.  The walk consumes the
// runs of both sides in the order of their run-end sums, equal sums by
// their ranks among equal sums, an x run before the y run of its rank (the
// pair the walk advances together): so the state on diagonal d is where
// that order's first d runs end (a binary search, as a merge path's, over
// the at most `span` + 1 counts of x runs that `base`, the count at
// diagonal d - span, leaves), and it is a step unless it ends between the
// two runs of a pair, or past either side's last run.  Writes the step into
// lane l of the chunk and says whether there is one and whether its
// entries rise: the first, and the second where the walk emits it.
template <typename T>
EM_HD unsigned path_step(const Row<T>& w, int j, int d, int base, int span,
                         const Chunk<T>& ch, int l, T rxyu, T nk,
                         const Consts<T>& c) {
  const int nx = w.runs[0], ny = w.runs[1];
  if (d > nx + ny - 2) return 0;
  const T* sx = w.e + j * w.ld;
  const T* sy = w.sy + j * w.ld;
  const int* kx = w.xrk + j * w.ld;
  const int* ky = w.yrk + j * w.ld;
  int lo = d - ny > base ? d - ny : base;
  int hi = d < nx ? d : nx;
  hi = base + span < hi ? base + span : hi;
  while (lo < hi) {  // the x runs among the order's first d
    const int mid = (lo + hi) >> 1, other = d - 1 - mid;
    const T vx = sx[mid], vy = sy[other];
    if (vx < vy || (vx == vy && kx[mid] <= ky[other]))
      lo = mid + 1;
    else
      hi = mid;
  }
  const int ra = lo, rb = d - lo;
  ch.ra[l] = ra;
  if (ra >= nx || rb >= ny) return 0;
  if (ra > 0 && sx[ra - 1] == sy[rb] && kx[ra - 1] == ky[rb]) return 0;
  const int i = w.xe[ra], jj = w.ye[rb];
  const T tx = sx[ra], ty = sy[rb];
  // both runs end at one sum: advance both; else the lesser (y unless x)
  const bool eq = tx == ty, lt = tx < ty;
  const bool two = eq   ? ra + 1 < nx && rb + 1 < ny
                   : lt ? ra + 1 < nx
                        : rb + 1 < ny;
  const T sum = eq || lt ? tx : ty;
  const T x1 = w.xs[i], y1 = w.ys[jj];
  const T x2 = w.xs[two && (eq || lt) ? i + 1 : i];
  const T y2 = w.ys[two && !lt ? jj + 1 : jj];
  ch.x1[l] = x1; ch.y1[l] = y1; ch.s1[l] = sum;
  ch.x2[l] = x2; ch.y2[l] = y2; ch.s2[l] = sum;
  ch.two[l] = two;
  const bool up1 = rises(rxyu, nk, x1, y1, sum, c);
  const bool up2 = rises(rxyu, nk, x2, y2, sum, c) && two;
  return kHasStep | (up1 ? kFirstRises : 0u) | (up2 ? kSecondRises : 0u);
}

// The exact M-step of component j on one warp, after m_sums: the walk's
// path, kLanes diagonals at a time, each lane's step placed by path_step and
// its entries tested at once (the division kept); ballots find the first
// rising entry in path order, the one the walk stops at, and the entry
// before it.  The same entries, sums and stop as m_step_walk's, so the
// same bits.  Every lane writes a and b the same.
template <typename T, typename Team>
EM_HD T m_step_warp(const Team& team, const Row<T>& w, int j,
                    const Consts<T>& c, const Chunk<T>& ch, T& a, T& b) {
  const T nk = w.sums[2 * j], rxyu = w.sums[2 * j + 1];
  if (!(nk > T(0))) return nk;
  Path<T> p = {rxyu, nk, T(0), T(0), T(0), T(0), T(0), T(0), 0};
  if (p.step(w.xs[0], w.ys[0], T(0), c)) {  // the first entry rises
    p.breakpoint(true, c, a, b);
    return nk;
  }
  // the path's last entry so far, and the one before it
  Entry<T> last = {p.cx, p.cy, p.cs}, before = {T(0), T(0), T(0)};
  bool up = false;
  int base = 0;  // the x runs before the state on diagonal d0 - 1
  for (int d0 = 0; !up; d0 += kLanes) {
    team.warp_sync();  // every lane has read the last chunk
    unsigned m[3];
    team.template ballots<3>(
        [&](int l) {
          return path_step(w, j, d0 + l, base, l + 1, ch, l, rxyu, nk, c);
        },
        m);
    const unsigned has = m[0], up1 = m[1], at = m[1] | m[2];
    if (!has) break;  // past the walk's end
    team.warp_sync();
    base = ch.ra[kLanes - 1];
    const int f = at ? lowest_lane(at) : highest_lane(has);
    const unsigned earlier = has & ((1u << f) - 1);
    Entry<T> cur;
    if (at && !(up1 >> f & 1)) {  // the step's second entry stops it
      cur = ch.second(f);
      before = ch.first(f);
    } else if (at) {
      cur = ch.first(f);
      before = earlier ? ch.last(highest_lane(earlier)) : last;
    } else {  // no rising entry: the chunk's last step ends the path so far
      cur = ch.last(f);
      before = ch.two[f] ? ch.first(f)
                         : earlier ? ch.last(highest_lane(earlier)) : last;
    }
    last = cur;
    up = at != 0;
  }
  p.cx = last.x; p.cy = last.y; p.cs = last.sum;
  p.px = before.x; p.py = before.y; p.ps = before.sum;
  p.count = 2;
  p.breakpoint(up, c, a, b);
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

// The M-step of the row's KM components into a, b and w: by the warp form,
// or (kWalk) by the walk, one thread a component.
template <bool kWalk, typename T, typename Team>
EM_HD void m_step_row(const Team& team, Row<T>& w, int n, int k, int KM,
                      const Consts<T>& c) {
  const T n_points = T(n > 1 ? n : 1);
  if (kWalk) {
    for (int j = team.rank(); j < KM; j += team.size()) {
      const T nk = j < k ? m_step_walk(w.r + j * w.ld, w, n, c, w.a[j],
                                       w.b[j])
                         : T(0);
      w.w[j] = nk / n_points;
    }
    return;
  }
  m_sums(team, w, n, k);
  team.sync();
  const Chunk<T> chunk = chunk_of(w, team.warp());
  for (int j = team.warp(); j < KM; j += team.warps()) {
    const T nk = j < k ? m_step_warp(team, w, j, c, chunk, w.a[j], w.b[j])
                       : T(0);
    w.w[j] = nk / n_points;
  }
}

// The row's EM from its carry to convergence, failure or max_iters.  A
// Team gives rank(), size(), sync(), any(flag) (a barrier that ORs flags),
// ll_sum(v, n, slot): the sum of v[0..n) in one fixed order, the same on
// every Team; and of a warp: warp(), warps(), ballots<kBits>(pred, mask),
// the bits of the lanes' pred(lane) as masks, warp_sync() (the warp's lanes wait for each other
// and see each other's writes).
template <bool kWalk, typename T, typename Team>
EM_HD void run_row(const Team& team, Row<T>& w, int n, int k, int KM,
                   const Consts<T>& c, int max_iters, int never, T& last_ll,
                   bool& done, bool& failed, int& it_done) {
  sort_points(team, w, n);
  team.sync();
  mark_runs(team, w, n);
  team.sync();
  done = failed = false;
  it_done = never;
  for (int it = 0; it < max_iters; ++it) {
    m_step_row<kWalk>(team, w, n, k, KM, c);
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

// A row's points and a, b from the batch into its arrays; w zeroed.
template <typename T, typename Team>
EM_HD void load_row(const Team& team, const Batch<T>& p, int row,
                    Row<T>& w) {
  const int KM = p.KM, N = p.N, n = p.n[row];
  const size_t at = (size_t)row * N, at_k = (size_t)row * KM;
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
}

// One row of the batch, start to end: the carry into the row's arrays
// (`base`, for `warps` warps; r stays in the carry unless r_inside), the
// EM, and back.
template <bool kWalk, typename T, typename Team>
EM_HD void process_row(const Team& team, const Batch<T>& p, int row,
                       unsigned char* base, bool r_inside) {
  const int KM = p.KM, N = p.N, n = p.n[row], k = p.k[row];
  const size_t at_k = (size_t)row * KM;
  T* r_row = p.r + at_k * N;
  Row<T> w = carve<T>(base, KM, N, team.warps(), r_inside ? nullptr : r_row);
  load_row(team, p, row, w);
  if (r_inside)
    for (int q = team.rank(); q < KM * n; q += team.size())
      w.r[(q / n) * N + q % n] = r_row[(q / n) * N + q % n];
  team.sync();
  T ll = p.ll[row];
  bool done, failed;
  int it_done;
  run_row<kWalk>(team, w, n, k, KM, p.c, p.max_iters, p.never, ll, done,
                 failed, it_done);
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

// Both M-steps of one row on the batch's r, a and b (left as they are):
// the walk's a, b and nk into out[0], out[1], out[2] and the warp form's
// into out[3], out[4], out[5], each (B, KM) (components past k: nk 0, a
// and b as given).  For the checks that hold the two to the same bits.
template <typename T, typename Team>
EM_HD void check_row(const Team& team, const Batch<T>& p, int row,
                     unsigned char* base, T* out) {
  const int KM = p.KM, N = p.N, n = p.n[row], k = p.k[row];
  const size_t at_k = (size_t)row * KM, plane = (size_t)p.B * KM;
  Row<T> w = carve<T>(base, KM, N, team.warps(), p.r + at_k * N);
  load_row(team, p, row, w);
  team.sync();
  sort_points(team, w, n);
  team.sync();
  mark_runs(team, w, n);
  team.sync();
  auto keep = [&](int form, int j, T a, T b, T nk) {
    T* o = out + 3 * form * plane + at_k + j;
    o[0] = a;
    o[plane] = b;
    o[2 * plane] = nk;
  };
  for (int j = team.rank(); j < KM; j += team.size()) {
    T a = w.a[j], b = w.b[j];
    const T nk = j < k ? m_step_walk(w.r + j * w.ld, w, n, p.c, a, b) : T(0);
    keep(0, j, a, b, nk);
    if (j >= k) keep(1, j, a, b, nk);
  }
  m_sums(team, w, n, k);
  team.sync();
  const Chunk<T> chunk = chunk_of(w, team.warp());
  for (int j = team.warp(); j < k; j += team.warps()) {
    T a = w.a[j], b = w.b[j];
    const T nk = m_step_warp(team, w, j, p.c, chunk, a, b);
    keep(1, j, a, b, nk);
  }
}

// The host's Team: one thread that plays one warp's lanes in a loop, and
// the card's order for the log-likelihood (kLanes strided partial sums,
// then a halving tree).
struct HostTeam {
  int rank() const { return 0; }
  int size() const { return 1; }
  int warp() const { return 0; }
  int warps() const { return 1; }
  void sync() const {}
  void warp_sync() const {}
  bool any(bool v) const { return v; }

  // mask[b]: the lanes whose pred(lane) has bit b
  template <int kBits, typename F> void ballots(F pred, unsigned* mask) const {
    for (int b = 0; b < kBits; ++b) mask[b] = 0;
    for (int l = 0; l < kLanes; ++l) {
      const unsigned v = pred(l);
      for (int b = 0; b < kBits; ++b) mask[b] |= (v >> b & 1u) << l;
    }
  }

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
