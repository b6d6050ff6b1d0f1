// Tie columns of selected split-DP rows: the code of one lane group.
//
// What csrc/split_dp.cu's tie_kernel runs (a group of LANES lanes of a
// warp, two instances in the int16 halves of its registers) and what
// csrc/tie_host.cpp runs on the host (one thread plays the group's lanes
// in a loop), so that the CPU tests hold the kernel's own code to the JAX
// dp_tie_columns.  What differs between the two builds is a Team: how the
// lanes are dealt out (one lane a thread, or all of them in a loop), how
// they wait for each other, and how a row's values cross lanes (shuffles,
// or loops over the lanes' values).
//
// The row step is split_dp.cu's (dp_rows), repeated: registers hold
// z = -(col + 2i + 2j), the diagonal is one add-min, the horizontal gap an
// inclusive min-scan across the group and a running min over the lane's
// columns.  What is the tie kernel's own is what happens around it:
//
// * The rows a group captures are a set of bits in shared memory, the
//   union of both halves' selections, read from row_sel once before the
//   loop.  A captured row's rank in that set is its slot.
// * At a captured row no lane waits for another and nothing leaves shared
//   memory: each lane takes the min of its own columns' z + 2i and the bits
//   of its columns that reach it, and stores both (both halves packed) in
//   the row's slot.  Where the group's min is the lane's own, those bits
//   are the row's tie columns in the lane's span; elsewhere they count for
//   nothing.  The group moves to its next captured row (a bit scan).
// * After the loop the group reduces each slot's min over its lanes; each
//   entry of both instances gets its slot and score once (a lane an entry,
//   writing the rowmax), and then a lane a (half, word) writes that word of
//   every entry, consecutive lanes on consecutive words: the OR of the bits
//   of the lanes whose span meets it and whose min is the group's, where
//   the row clears the anchor.  An entry that names no row of the DP (-1,
//   0, past L) gets 0 and no bits in the same pass.
// * A group keeps at most S slots (the launch's choice, from M and L); one
//   with more captured rows runs the DP again for each further S of them.

#pragma once

#include <stdint.h>

#ifdef __CUDACC__
#define TIE_FN __host__ __device__ __forceinline__
#define TIE_UNROLL _Pragma("unroll")
#else
#define TIE_FN inline
#define TIE_UNROLL
#endif

namespace tie {

constexpr unsigned kFull = 0xffffffffu;
constexpr int kFar = 20000;
constexpr int kNone = 1 << 30;  // no further captured row

TIE_FN constexpr unsigned pack2(int lo, int hi) {
  return ((unsigned)lo & 0xffffu) | ((unsigned)hi << 16);
}
TIE_FN int lo16(unsigned v) { return (int)(short)(v & 0xffffu); }
TIE_FN int hi16(unsigned v) { return (int)(short)(v >> 16); }
TIE_FN int align16(int x) { return (x + 15) & ~15; }
TIE_FN unsigned neg4(unsigned ch) { return (0u - (ch << 2)) & 0xffffu; }

// The int16x2 (and uint16x2) instructions of the row step: the card's
// SIMD intrinsics, or the same arithmetic a half at a time.
#ifdef __CUDA_ARCH__
__device__ __forceinline__ unsigned add2(unsigned a, unsigned b) {
  return __vadd2(a, b);
}
__device__ __forceinline__ unsigned min2(unsigned a, unsigned b) {
  return __vmins2(a, b);
}
__device__ __forceinline__ unsigned min3(unsigned a, unsigned b, unsigned c) {
  return __vimin3_s16x2(a, b, c);
}
// min(a + b, c), signed
__device__ __forceinline__ unsigned addmin2(unsigned a, unsigned b,
                                            unsigned c) {
  return __viaddmin_s16x2(a, b, c);
}
// min(a + b, c), unsigned, the sum mod 2^16
__device__ __forceinline__ unsigned addmin_u2(unsigned a, unsigned b,
                                              unsigned c) {
  return __viaddmin_u16x2(a, b, c);
}
__device__ __forceinline__ unsigned eq2(unsigned a, unsigned b) {
  return __vcmpeq2(a, b);
}
__device__ __forceinline__ int popc(unsigned v) { return __popc(v); }
__device__ __forceinline__ int ctz(unsigned v) { return __ffs(v) - 1; }
#else
inline unsigned halves(unsigned lo, unsigned hi) {
  return (lo & 0xffffu) | (hi << 16);
}
inline unsigned add2(unsigned a, unsigned b) {
  return halves(a + b, (a >> 16) + (b >> 16));
}
inline unsigned min2(unsigned a, unsigned b) {
  const int lo = lo16(a) < lo16(b) ? lo16(a) : lo16(b);
  const int hi = hi16(a) < hi16(b) ? hi16(a) : hi16(b);
  return pack2(lo, hi);
}
inline unsigned min3(unsigned a, unsigned b, unsigned c) {
  return min2(min2(a, b), c);
}
inline unsigned addmin2(unsigned a, unsigned b, unsigned c) {
  return min2(add2(a, b), c);
}
inline unsigned addmin_u2(unsigned a, unsigned b, unsigned c) {
  const unsigned s = add2(a, b);
  const unsigned lo = (s & 0xffffu) < (c & 0xffffu) ? s : c;
  const unsigned hi = (s >> 16) < (c >> 16) ? s : c;
  return (lo & 0xffffu) | (hi & 0xffff0000u);
}
inline unsigned eq2(unsigned a, unsigned b) {
  return ((a & 0xffffu) == (b & 0xffffu) ? 0xffffu : 0u) |
         ((a >> 16) == (b >> 16) ? 0xffff0000u : 0u);
}
inline int popc(unsigned v) { return __builtin_popcount(v); }
inline int ctz(unsigned v) { return __builtin_ctz(v); }
#endif

// The phase clock (utils/time_rowmax.py --phases builds split_dp.cu with
// TIE_PHASE_CLOCK): each warp's SM clock where each phase ends, once its
// lanes have all reached it.  Without it TIE_PHASE is nothing.
#if defined(TIE_PHASE_CLOCK) && defined(__CUDACC__)
constexpr int kClockWarps = 8192, kPhases = 7;
__device__ long long clock_at[kClockWarps][kPhases];
TIE_FN void stamp(int n) {
#ifdef __CUDA_ARCH__
  const int64_t w = ((int64_t)blockIdx.x * blockDim.x + threadIdx.x) / 32;
  __syncwarp();
  if (threadIdx.x % 32 == 0 && w < kClockWarps) clock_at[w][n] = clock64();
#endif
}
#define TIE_PHASE(n) tie::stamp(n)
#else
#define TIE_PHASE(n)
#endif

// Words of the captured-row set: rows 0..L, one bit a row.
TIE_FN int row_words(int L) { return (L + 32) / 32; }

// Shared memory of one group, in 32-bit words: the negated read characters
// of each row, the captured-row set, its running counts, the first MC row
// selections of each half and their entries of a pass, and S slots of a
// lane's min and bits (both halves) with the group's min of each.
TIE_FN int group_words(int L, int S, int MC, int lanes) {
  return align16(L) + align16(row_words(L)) + align16(row_words(L) + 1) +
         2 * align16(2 * MC) + align16(S * (3 * lanes + 1));
}

struct Mem {
  unsigned* nrd;      // [L]: row j reads nrd[j-1], both reads packed
  unsigned* rowset;   // [row_words(L)]: bit j, row j captured by a half
  int* cum;           // [row_words(L)+1]: set rows in the words before w
  int* sel;           // [2][MC]: row_sel of each half, its first MC slots
  int* ent;           // [2][MC]: their entries in a pass (see entry())
  unsigned* best;     // [S][LANES]: min of z + 2i over the lane's columns
  unsigned* bits_lo;  // [S][LANES]: the lane's columns that reach it
  unsigned* bits_hi;
  unsigned* gmin;     // [S]: the group's min of best
};

TIE_FN Mem carve(unsigned* base, int L, int S, int MC, int lanes) {
  Mem m;
  m.nrd = base;
  m.rowset = m.nrd + align16(L);
  m.cum = reinterpret_cast<int*>(m.rowset + align16(row_words(L)));
  m.sel = m.cum + align16(row_words(L) + 1);
  m.ent = m.sel + align16(2 * MC);
  m.best = reinterpret_cast<unsigned*>(m.ent + align16(2 * MC));
  m.bits_lo = m.best + S * lanes;
  m.bits_hi = m.bits_lo + S * lanes;
  m.gmin = m.bits_hi + S * lanes;
  return m;
}

// The operands of a launch (split_dp_tie_columns).
struct Args {
  const uint8_t* refs;
  const int* ref_lens;
  int R;
  const uint8_t* reads;
  int L;
  const int* row_sel;
  int M;
  int* rowmax;
  int* packed;
  int B;
  int S;   // captured rows a group keeps a pass
  int MC;  // row selections of a half kept in shared memory
  int min_split;
};

// The two instances of a group: 2p in the low half, 2p+1 in the high.  A
// half past the end of the batch computes a copy of the low one and writes
// nothing; a group past the end writes nothing at all.  The flank lengths
// come in the prologue.
struct Pair {
  int64_t i[2];
  bool live[2];
  int len[2];
};

TIE_FN Pair make_pair(const Args& a, int64_t p) {
  Pair pr;
  const int64_t b0 = 2 * p;
  pr.live[0] = b0 < a.B;
  pr.live[1] = b0 + 1 < a.B;
  pr.i[0] = pr.live[0] ? b0 : 0;
  pr.i[1] = pr.live[1] ? b0 + 1 : pr.i[0];
  pr.len[0] = pr.len[1] = 0;
  return pr;
}

// What the warp takes the most of over its groups: the columns a group
// needs (ref_len + 1), the largest captured row, the passes of S slots.
struct Plan {
  int need, rows, passes;
};

// The captured row of rank r (r below the set's count).
TIE_FN int row_of_rank(const Mem& s, int r) {
  int w = 0;
  while (s.cum[w + 1] <= r) ++w;
  unsigned bits = s.rowset[w];
  for (int q = r - s.cum[w]; q > 0; --q) bits &= bits - 1;
  return (w << 5) + ctz(bits);
}

// The first captured row after row j, or kNone.
TIE_FN int next_row(const Mem& s, int nw, int j) {
  int w = (j + 1) >> 5;
  if (w >= nw) return kNone;
  unsigned bits = s.rowset[w] & (kFull << ((j + 1) & 31));
  while (!bits && ++w < nw) bits = s.rowset[w];
  return bits ? (w << 5) + ctz(bits) : kNone;
}

TIE_FN int rank_of(const Mem& s, int j) {
  return s.cum[j >> 5] + popc(s.rowset[j >> 5] & ((1u << (j & 31)) - 1u));
}

// The group's flank lengths, the read's rows (all L), its row selections
// (the first MC of each half into shared memory) and captured-row set,
// and its part of the plan.  The lengths and each lane's first selection
// are loaded before the rows, so that one wait covers all three.
template <int LANES, class Team>
TIE_FN Plan prologue(const Team& t, const Args& a, Pair& pr, const Mem& s) {
  constexpr int K = Team::kHere;
  const int nw = row_words(a.L);
  int n[2], first[K];
  for (int h = 0; h < 2; ++h) n[h] = pr.live[h] ? a.ref_lens[pr.i[h]] : 0;
  for (int k = 0; k < K; ++k) {
    const int g = t.lane(k), h = g >= a.M;
    first[k] = g < 2 * a.M && pr.live[h]
                   ? a.row_sel[pr.i[h] * a.M + (g - h * a.M)]
                   : -1;
    for (int w = g; w < nw; w += LANES) s.rowset[w] = 0u;
  }
  t.sync();
  const uint8_t* rd0 = a.reads + pr.i[0] * a.L;
  const uint8_t* rd1 = a.reads + pr.i[1] * a.L;
  for (int k = 0; k < K; ++k) {
    const int g = t.lane(k);
    for (int p = g; p < a.L; p += LANES)
      s.nrd[p] = neg4(rd0[p]) | (neg4(rd1[p]) << 16);
  }
  for (int k = 0; k < K; ++k) {
    const int g = t.lane(k);
    for (int e = g; e < 2 * a.M; e += LANES) {
      const int h = e >= a.M, m = e - h * a.M;
      if (!pr.live[h]) continue;
      const int j = e == g ? first[k] : a.row_sel[pr.i[h] * a.M + m];
      if (m < a.MC) s.sel[h * a.MC + m] = j;
      if (j >= 1 && j <= a.L) t.or_into(&s.rowset[j >> 5], 1u << (j & 31));
    }
  }
  for (int h = 0; h < 2; ++h)
    pr.len[h] = n[h] < 0 ? 0 : (n[h] > a.R ? a.R : n[h]);
  t.sync();
  for (int k = 0; k < K; ++k) {
    const int g = t.lane(k);
    for (int w = g; w <= nw; w += LANES) {
      int n = 0;
      for (int v = 0; v < w; ++v) n += popc(s.rowset[v]);
      s.cum[w] = n;
    }
  }
  t.sync();
  const int count = s.cum[nw];
  const int last = count ? row_of_rank(s, count - 1) : 0;
  const int need = (pr.len[0] > pr.len[1] ? pr.len[0] : pr.len[1]) + 1;
  // one pass at least: it writes the entries that name no row of the DP
  return {need, last, count ? (count + a.S - 1) / a.S : 1};
}

// The min of v[A .. A+N-1], as a tree of three-way mins (depth log3 N).
template <int A, int N, int C>
TIE_FN unsigned min_of(const unsigned (&v)[C]) {
  if constexpr (N == 1) {
    return v[A];
  } else if constexpr (N == 2) {
    return min2(v[A], v[A + 1]);
  } else {
    constexpr int n1 = N / 3, n2 = (N - n1) / 2;
    return min3(min_of<A, n1>(v), min_of<A + n1, n2>(v),
                min_of<A + n1 + n2, N - n1 - n2>(v));
  }
}

// Row selection m of half h: from shared memory, or past the first MC
// from row_sel.
TIE_FN int selection(const Args& a, const Mem& s, const Pair& pr, int h,
                     int m) {
  return m < a.MC ? s.sel[h * a.MC + m] : a.row_sel[pr.i[h] * a.M + m];
}

// Where an entry of row j goes in the pass from slot `base`: its slot of
// the pass; kNoRow for a row of no DP (-1, 0, past L; written with 0 in
// the first pass); kElsewhere for a row of another pass.
constexpr int kNoRow = -1, kElsewhere = -2;
TIE_FN int slot_in(const Args& a, const Mem& s, int j, int base) {
  if (j < 1 || j > a.L) return base ? kElsewhere : kNoRow;
  const int slot = rank_of(s, j) - base;
  return slot >= 0 && slot < a.S ? slot : kElsewhere;
}

// The anchored max of row j of half h from its slot: 0 under the anchor
// and for a row of no DP.
TIE_FN int score_of(const Args& a, const Mem& s, int h, int slot, int j) {
  if (slot < 0) return 0;
  const int score = -(h ? hi16(s.gmin[slot]) : lo16(s.gmin[slot])) - 2 * j;
  return score >= a.min_split ? score : 0;
}

// Entry m of half h in the pass from slot `base`: (score << 8) | (slot +
// 2), the row's slot of the pass (kNoRow for a row of no DP) and its
// score; kNoEntry for a row of another pass.
constexpr int kNoEntry = 0;
TIE_FN int entry(const Args& a, const Mem& s, const Pair& pr, int h, int m,
                 int base) {
  const int j = selection(a, s, pr, h, m);
  const int slot = slot_in(a, s, j, base);
  if (slot == kElsewhere) return kNoEntry;
  return (score_of(a, s, h, slot, j) << 8) | (slot + 2);
}

// The tie entries of half h's captured row in slot `slot` of this pass,
// word w.
template <int C, int LANES>
TIE_FN unsigned word_of(const Mem& m, const int (&off)[2], int h, int slot,
                        int w) {
  const unsigned* bits = h ? m.bits_hi : m.bits_lo;
  const int gmin = h ? hi16(m.gmin[slot]) : lo16(m.gmin[slot]);
  // lanes whose DP columns g*C - off .. g*C - off + C - 1 meet 32w..32w+31
  int first = (32 * w + off[h] - (C - 1));
  first = first > 0 ? (first + C - 1) / C : 0;
  int end = (32 * w + 31 + off[h]) / C + 1;
  end = end < LANES ? end : LANES;
  unsigned out = 0u;
  for (int g = first; g < end; ++g) {
    const unsigned b = m.best[slot * LANES + g];
    if ((h ? hi16(b) : lo16(b)) != gmin) continue;
    const int d = g * C - off[h] - 32 * w;  // in (-C, 32)
    out |= d >= 0 ? bits[slot * LANES + g] << d
                  : bits[slot * LANES + g] >> -d;
  }
  return out;
}

// Columns a lane for the warp's widest flank, rounded up to a multiple of
// 4 (or CMAX): a quarter of the row loops to compile, for at most 3
// columns a lane more.
TIE_FN int columns(int need, int lanes, int cmax) {
  const int c = ((need + lanes - 1) / lanes + 3) / 4 * 4;
  return c < cmax ? c : cmax;
}

// every column count a lane the switch below may take
#define TIE_FOR_COLUMNS(X)                                                 \
  X(4) X(8) X(12) X(16) X(18) X(20) X(24) X(28) X(32)

// The rows of one pass of S slots (captured ranks base..base+S-1) of one
// group, to the warp's last captured row: C columns a lane; the registers
// hold z = -w (see split_dp.cu).  At a captured row of the pass each lane
// keeps its min and bits in the row's slot.
template <int C, int LANES, class Team>
TIE_FN void rows(const Team& t, const Args& a, const Pair& pr, const Mem& s,
                 const Plan& warp, int base) {
  constexpr int K = Team::kHere;
  constexpr int CW = LANES * C;
  constexpr unsigned kFar2 = pack2(kFar, kFar);
  const int off[2] = {CW - 1 - pr.len[0], CW - 1 - pr.len[1]};
  const int nw = row_words(a.L);
  const int count = s.cum[nw];
  const int end = count < base + a.S ? count : base + a.S;
  unsigned rc[K][C], z[K][C], tail[K], left[K];
  // characters times 4 and row 0; column p = g*C + c of a half holds DP
  // column p - off, left of column 0 at kFar
  for (int k = 0; k < K; ++k) {
    const int g = t.lane(k);
    TIE_UNROLL
    for (int c = 0; c < C; ++c) {
      const int x = g * C + c - off[0], y = g * C + c - off[1];
      const unsigned lo = x >= 1 ? a.refs[pr.i[0] * a.R + x - 1] : 0u;
      const unsigned hi = y >= 1 ? a.refs[pr.i[1] * a.R + y - 1] : 0u;
      rc[k][c] = (lo << 2) | (hi << 18);
      z[k][c] = pack2(x >= 0 ? -2 * x : kFar, y >= 0 ? -2 * y : kFar);
    }
    tail[k] = z[k][C - 1];
  }
  t.from_left(tail, left, kFar2);
  TIE_PHASE(3);
  int rank = base;
  int next = base < end ? row_of_rank(s, base) : kNone;
  // the row's read characters, a row ahead of the step that takes them
  unsigned nrd = s.nrd[0];
  for (int j = 1; j <= warp.rows; ++j) {
    const unsigned row_nrd = nrd;
    nrd = s.nrd[j < warp.rows ? j : 0];
    for (int k = 0; k < K; ++k) {
      // vertical and diagonal step, right to left:
      // z = min(diag + miss - 6, up), miss - 6 ahead of the diagonal
      TIE_UNROLL
      for (int c = C - 1; c >= 0; --c) {
        const unsigned diag = c == 0 ? left[k] : z[k][c - 1];
        const unsigned miss6 =
            add2(addmin_u2(rc[k][c], row_nrd, 0x00030003u), pack2(-6, -6));
        z[k][c] = addmin2(diag, miss6, z[k][c]);
      }
      tail[k] = min_of<0, C>(z[k]);
    }
    // inclusive min-scan across the group; the carry into each lane's
    // first column, also the next row's diagonal input
    t.scan_min(tail);
    t.from_left(tail, left, kFar2);
    for (int k = 0; k < K; ++k) {
      unsigned run = left[k];
      TIE_UNROLL
      for (int c = 0; c < C; ++c) {
        run = min2(run, z[k][c]);
        z[k][c] = run;
      }
    }
    if (j != next) continue;
    // a captured row: each lane's min of z + 2i and the columns at it
    const int slot = rank - base;
    for (int k = 0; k < K; ++k) {
      const int g = t.lane(k);
      unsigned best = kFar2;
      TIE_UNROLL
      for (int c = 0; c < C; ++c)
        best = addmin2(z[k][c], pack2(2 * c, 2 * c), best);
      unsigned lo = 0u, hi = 0u;
      TIE_UNROLL
      for (int c = 0; c < C; ++c) {
        const unsigned e = eq2(add2(z[k][c], pack2(2 * c, 2 * c)), best);
        lo |= (e & 1u) << c;
        hi |= (e >> 31) << c;
      }
      s.best[slot * LANES + g] =
          add2(best, pack2(2 * (g * C - off[0]), 2 * (g * C - off[1])));
      s.bits_lo[slot * LANES + g] = lo;
      s.bits_hi[slot * LANES + g] = hi;
    }
    ++rank;
    next = rank < end ? next_row(s, nw, j) : kNone;
  }
  t.sync();
  TIE_PHASE(4);
}

// After the rows of the pass from slot `base`: each slot's min over the
// group's lanes, then every entry of both halves whose row falls in the
// pass.
template <int C, int LANES, class Team>
TIE_FN void finish(const Team& t, const Args& a, const Pair& pr,
                   const Mem& s, int base) {
  constexpr int K = Team::kHere;
  const int off[2] = {LANES * C - 1 - pr.len[0], LANES * C - 1 - pr.len[1]};
  const int W = (a.R + 1 + 31) / 32;
  const int count = s.cum[row_words(a.L)];
  const int end = count < base + a.S ? count : base + a.S;
  // each slot's min over the group's lanes
  for (int k = 0; k < K; ++k) {
    const int g = t.lane(k);
    for (int q = g; q < end - base; q += LANES) {
      unsigned m = s.best[q * LANES];
      for (int l = 1; l < LANES; ++l) m = min2(m, s.best[q * LANES + l]);
      s.gmin[q] = m;
    }
  }
  t.sync();
  TIE_PHASE(5);
  // each half's scores, a lane an entry, and the entries of the first MC
  // into shared memory for the words
  for (int k = 0; k < K; ++k) {
    const int g = t.lane(k);
    for (int e = g; e < 2 * a.M; e += LANES) {
      const int h = e >= a.M, m = e - h * a.M;
      if (!pr.live[h]) continue;
      const int en = entry(a, s, pr, h, m, base);
      if (m < a.MC) s.ent[h * a.MC + m] = en;
      if (en != kNoEntry) a.rowmax[pr.i[h] * a.M + m] = en >> 8;
    }
  }
  t.sync();
  // the words: a lane a (half, word), over the half's entries, so that
  // consecutive lanes write consecutive words of an entry
  for (int k = 0; k < K; ++k) {
    const int g = t.lane(k);
    for (int q = g; q < 2 * W; q += LANES) {
      const int h = q >= W, w = q - h * W;
      if (!pr.live[h]) continue;
      int* out = a.packed + pr.i[h] * a.M * W + w;
      for (int m = 0; m < a.M; ++m) {
        const int en = m < a.MC ? s.ent[h * a.MC + m]
                                : entry(a, s, pr, h, m, base);
        if (en == kNoEntry) continue;
        out[m * W] = en >> 8 ? (int)word_of<C, LANES>(s, off, h,
                                                      (en & 255) - 2, w)
                             : 0;
      }
    }
  }
  t.sync();
}

// A group's DP and entries for C columns a lane, a pass of S slots at a
// time.
template <int C, int LANES, class Team>
TIE_FN void body(const Team& t, const Args& a, const Pair& pr, const Mem& s,
                 const Plan& warp) {
  TIE_PHASE(2);
  for (int pass = 0; pass < warp.passes; ++pass) {
    rows<C, LANES>(t, a, pr, s, warp, pass * a.S);
    finish<C, LANES>(t, a, pr, s, pass * a.S);
  }
}

// body<C> for the warp's column count (a multiple of 4, or CMAX).
template <int CMAX, int LANES, class Team>
TIE_FN void run_group(const Team& t, const Args& a, const Pair& pr,
                      const Mem& s, const Plan& warp) {
  switch (columns(warp.need, LANES, CMAX)) {
#define TIE_CASE(N)                                                        \
  case N:                                                                  \
    if constexpr (N <= CMAX && (N % 4 == 0 || N == CMAX))                  \
      body<N, LANES>(t, a, pr, s, warp);                                   \
    break;
    TIE_FOR_COLUMNS(TIE_CASE)
#undef TIE_CASE
  }
}

// A group of the card: this thread is lane g of it.
#ifdef __CUDACC__
template <int LANES>
struct WarpTeam {
  static constexpr int kHere = 1;
  int g;
  // the group's lane that this thread's k-th (only) lane state plays
  __device__ __forceinline__ int lane(int) const { return g; }
  __device__ __forceinline__ void sync() const { __syncwarp(); }
  __device__ __forceinline__ void or_into(unsigned* w, unsigned v) const {
    atomicOr(w, v);
  }
  // inclusive min-scan of v over the group's lanes (a lane below the step
  // gets its own value back, which changes nothing)
  __device__ __forceinline__ void scan_min(unsigned (&v)[1]) const {
    TIE_UNROLL
    for (int d = 1; d < LANES; d <<= 1)
      v[0] = __vmins2(v[0], __shfl_up_sync(kFull, v[0], d, LANES));
  }
  // out = v of the lane to the left; fill for the group's first lane
  __device__ __forceinline__ void from_left(const unsigned (&v)[1],
                                            unsigned (&out)[1],
                                            unsigned fill) const {
    out[0] = __shfl_up_sync(kFull, v[0], 1, LANES);
    if (g == 0) out[0] = fill;
  }
};
#endif

// A group on the host: one thread plays its LANES lanes, one after another
// between the points where the card's lanes meet.
template <int LANES>
struct HostTeam {
  static constexpr int kHere = LANES;
  int lane(int k) const { return k; }
  void sync() const {}
  void or_into(unsigned* w, unsigned v) const { *w |= v; }
  void scan_min(unsigned (&v)[LANES]) const {
    for (int g = 1; g < LANES; ++g) v[g] = min2(v[g], v[g - 1]);
  }
  void from_left(const unsigned (&v)[LANES], unsigned (&out)[LANES],
                 unsigned fill) const {
    for (int g = LANES - 1; g >= 1; --g) out[g] = v[g - 1];
    out[0] = fill;
  }
};

}  // namespace tie
