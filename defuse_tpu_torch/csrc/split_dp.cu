// Split-read DP for Hopper (sm_90a): a group of 8, 16 or 32 lanes per
// candidate, both of its DPs in the two halves of int16x2 registers.
//
// Replaces the TPU kernel defuse_tpu/ops/split_dp_pallas.py::_dp_kernel
// (rowmax_kernel and, with the flank gather, read reversal and combine
// that _screen_candidates wraps around it, screen_kernel), and the XLA
// program defuse_tpu/ops/split_dp_batch.py::dp_tie_columns (tie_kernel).
// All three run the same row step (dp_rows; tie_rows repeats it) at the
// lanes a group that shape_for gives the table's width.
//
// Recurrence (integer, bit-exact with ops/split_dp_batch.dp_row_maxima):
// DP column i = 0..ref_len holds ref position i-1 (column 0 is the
// boundary).  Row 0 is all zeros (free start in the flank).  For read row j:
//   vert[0] = GAP*j
//   vert[i] = max(prev[i-1] + (ref[i-1]==read[j-1] ? MATCH : MISMATCH),
//                 prev[i] + GAP)
//   col[i]  = max(vert[i], col[i-1] + GAP)          (horizontal gap)
// rowmax[j] is the max of col over i <= ref_len, set to 0 below
// MIN_SPLIT_SCORE and for rows j > read_len.
//
// What bounds it on the card: integer issue, not bytes.  A candidate is
// 2*n*(ref_len+1) cell updates from a few hundred bytes of input.  The
// bound (ops/split_dp_census.screen_bound) gives a cell five instructions
// (substitution score, one add, two add-max, one row max) with two cells to
// an int16x2 register, at the card's measured issue rates.  What the design
// does to come near it:
//
// * Two DPs in one register.  The forward DP (flank 1, read) and the
//   reversed DP (reversed flank 2, reversed read) of a candidate share the
//   row count n and nothing else; they run in the low and the high half of
//   the same registers through the 16x2 DPX instructions (VIADDMNMX.S16,
//   VIMNMX.S16, VIADD.16), so one set of shuffles and one row reduction
//   serves both.  The row-maxima and tie entries pack two instances the
//   same way.
// * No gap arithmetic.  With w[j][i] = col[j][i] - GAP*(i+j) (GAP = -2:
//   w = col + 2i + 2j) a vertical or horizontal gap step costs nothing and
//   the diagonal adds s = sub - 2*GAP, 6 on a match and 3 otherwise:
//     w[j][i] = max(w[j-1][i-1] + s, w[j-1][i], w[j][i-1])
//   so the horizontal gap is a plain prefix max: per lane a max of its
//   columns, a 5-step shuffle scan of those across lanes, and one running
//   max over the lane's columns started from the carry.  The carry of row j
//   is also the diagonal input of row j+1.  The row max undoes the column
//   term with an immediate: max_i(w[i] - 2i).
// * No compare and select.  Characters are kept times 4, the read's negated
//   (built once per candidate in shared memory), so
//   miss = min_u16(4*ref - 4*read, 3) is 0 on a match and 3 otherwise, one
//   VIADDMNMX.U16x2.  The registers hold z = -w, so that the diagonal is
//   one add of a register pair and one add-min with an immediate:
//     z = min(z_diag + miss - 6, z_up)
//   (in w the subtraction of a register costs three instructions); every
//   max above is a min in the code.
// * No column masks.  Each half is right-aligned in the warp's 32*C
//   columns: its last column is ref_len, and the columns left of its column
//   0 start at w = -kFar.  They can rise by at most 6 a row and nothing
//   valid flows leftwards, so they stay below every valid value and column
//   0 stays GAP*j by the recurrence itself.
// * Columns follow the flank, and lanes follow the table.  A candidate
//   runs on a group of 8, 16 or 32 lanes (by the table's width R, see
//   shape_for), so a warp's per-row work (the scan's shuffles, the read
//   character, the loop) serves 4, 2 or 1 candidates.  C is the least
//   count with LANES*C >= max(ref_len)+1 over the warp's candidates, any
//   value up to the kernel's bound (16, 18, 16 or 32: it bounds the
//   registers), picked per warp inside the kernel by a warp-uniform switch.
//   A warp runs as many rows as its longest read; a group with fewer keeps
//   nothing of the rest.
// * Row maxima leave the row loop as one shared-memory store a lane; every
//   32 rows the group reduces its tile transposed (a lane takes whole rows).
// * Tie columns (tie_kernel) keep no rows: the DP runs to the last row a
//   warp captures, and at a captured row each lane keeps, in shared memory,
//   the min of its own columns and the bits of those that reach it; after
//   the loop the group reduces them and writes every entry in one pass
//   (tie_rows.cuh, whose row step repeats this one).  Its bound is the same
//   integer issue over the cells up to each instance's largest selected
//   row; at the no-native route's shape (a few thousand instances, 50 rows)
//   its time is the latency of a warp's row chain and the launch.
//
// Value ranges (int16): j <= 1024 rows, i <= 1023.  Valid w = col+2i+2j lies
// in [0, 4j+2i] <= 6142 (col in [-2j, 2j]); w + s <= 6148.  Left of column 0
// values lie in [-kFar - 3, -kFar + 6j] <= -13856, and their row-max term
// w - 2i <= -13856 + 2046 < 0 <= any valid one.  Nothing leaves int16.

#include <cuda_runtime.h>
#include <stdint.h>

#include <algorithm>

#include "tie_rows.cuh"

namespace {

constexpr int kWarp = 32;
constexpr int kWarpsPerBlock = 4;
constexpr unsigned kFull = 0xffffffffu;
constexpr int kTileRows = 32;
constexpr int kFar = 20000;
constexpr int kMaxRead = 1024;
constexpr int kTieSlots = 32;       // captured rows a tie group keeps a pass
constexpr int kTieSelections = 64;  // row selections a half kept in shared

struct Scores {
  int match, mismatch, gap, min_split;
};

__host__ __device__ constexpr unsigned pack2(int lo, int hi) {
  return ((unsigned)lo & 0xffffu) | ((unsigned)hi << 16);
}
__device__ __forceinline__ int lo16(unsigned v) { return (int)(short)(v & 0xffffu); }
__device__ __forceinline__ int hi16(unsigned v) { return (int)v >> 16; }

__host__ __device__ inline int align16(int x) { return (x + 15) & ~15; }

// Shared memory of one group (the LANES lanes that share a pair of DPs):
// the negated read characters of each row (nrd[j-1] for row j), the packed
// row maxima rm[0..L] and the tile of per-lane row maxima, kTileRows rows
// of LANES entries, one word apart so transposed reads spread over banks.
__host__ __device__ inline int group_smem_words(int L, int lanes) {
  return align16(L) + align16(L + 1) + kTileRows * (lanes + 1);
}

// What one group works on.  The low half runs ref_lo (len_lo) and the high
// half ref_hi (len_hi) against the rows of nrd (n of them, each the packed
// negated characters times 4 of the two reads).
struct Pair {
  const uint8_t* ref_lo;
  const uint8_t* ref_hi;
  int len_lo, len_hi, n;
  const unsigned* nrd;
  unsigned* rm;
  unsigned* tile;
};

// Reduce the tile's first `rows` rows: each lane of the group takes every
// LANES-th row, the min over the group's entries (-(score + 2j)), back to
// scores and thresholded per half.
template <int LANES>
__device__ __forceinline__ void reduce_tile(const Pair& pr, int j0, int rows,
                                            int g, int min_split) {
  __syncwarp();
#pragma unroll 1
  for (int r = g; r < rows; r += LANES) {
    const unsigned* t = pr.tile + r * (LANES + 1);
    unsigned m = t[0];
#pragma unroll
    for (int k = 1; k + 1 < LANES; k += 2) m = __vimin3_s16x2(m, t[k], t[k + 1]);
    m = __vmins2(m, t[LANES - 1]);
    const int j = j0 + r;
    int lo = -lo16(m) - 2 * j, hi = -hi16(m) - 2 * j;
    lo = lo >= min_split ? lo : 0;
    hi = hi >= min_split ? hi : 0;
    if (j <= pr.n) pr.rm[j] = pack2(lo, hi);
  }
  __syncwarp();
}

// The DPs of one warp: each group of LANES lanes runs its pair over its own
// LANES*C columns, for `rows` rows (the most any group of the warp needs; a
// group with fewer rows computes on and keeps nothing of them).  Writes
// rm[0..n] of each pair, the two thresholded row maxima packed.  The
// registers hold z = -w.
template <int C, int LANES>
__device__ __forceinline__ void dp_rows(const Pair& pr, int rows,
                                        int min_split, int g) {
  constexpr int W = LANES * C;
  const int off_lo = W - 1 - pr.len_lo, off_hi = W - 1 - pr.len_hi;
  unsigned rc[C], z[C];
  // characters times 4, and row 0: col = 0, so z = -2i; left of column 0
  // kFar.  Column p = g*C + c of a half holds DP column i = p - off of that
  // half, ref position i - 1.
#pragma unroll
  for (int c = 0; c < C; ++c) {
    const int a = g * C + c - off_lo, b = g * C + c - off_hi;
    const unsigned lo = a >= 1 ? pr.ref_lo[a - 1] : 0u;
    const unsigned hi = b >= 1 ? pr.ref_hi[b - 1] : 0u;
    rc[c] = (lo << 2) | (hi << 18);
    z[c] = pack2(a >= 0 ? -2 * a : kFar, b >= 0 ? -2 * b : kFar);
  }
  // row-max term of the lane's first column: 2i per half
  const unsigned lane_term =
      pack2(2 * (g * C - off_lo), 2 * (g * C - off_hi));
  constexpr unsigned kFar2 = pack2(kFar, kFar);
  // diagonal input of the lane's first column: the last column of the lane
  // to the left in the previous row
  unsigned left = __shfl_up_sync(kFull, z[C - 1], 1, LANES);
  if (g == 0) left = kFar2;
  if (g == 0) pr.rm[0] = 0;

  const unsigned* nrd_row = pr.nrd;
  unsigned* slot = pr.tile + g;  // this row's tile entry
  int r = 0;                     // rows in the tile
  for (int j = 1; j <= rows; ++j) {
    const unsigned nrd = *nrd_row++;
    // vertical and diagonal step in place, right to left so z[c-1] is
    // still the previous row's: z = min(diag - 6 + miss, up)
#pragma unroll
    for (int c = C - 1; c >= 0; --c) {
      const unsigned diag = (c == 0) ? left : z[c - 1];
      const unsigned miss = __viaddmin_u16x2(rc[c], nrd, 0x00030003u);
      z[c] = __viaddmin_s16x2(__vadd2(diag, miss), pack2(-6, -6), z[c]);
    }
    // the lane's min, then an inclusive min-scan across the group (a lane
    // below the step gets its own value back, which changes nothing)
    unsigned tail = z[0];
#pragma unroll
    for (int c = 1; c + 1 < C; c += 2) tail = __vimin3_s16x2(tail, z[c], z[c + 1]);
    if constexpr (C % 2 == 0) tail = __vmins2(tail, z[C - 1]);
#pragma unroll
    for (int d = 1; d < LANES; d <<= 1)
      tail = __vmins2(tail, __shfl_up_sync(kFull, tail, d, LANES));
    // what reaches this lane's first column from the lanes before it; also
    // the next row's diagonal input
    left = __shfl_up_sync(kFull, tail, 1, LANES);
    if (g == 0) left = kFar2;
    // horizontal gap: running min from the carry; row min of z + 2i
    unsigned run = left, best = kFar2;
#pragma unroll
    for (int c = 0; c < C; ++c) {
      run = __vmins2(run, z[c]);
      z[c] = run;
      best = __viaddmin_s16x2(run, pack2(2 * c, 2 * c), best);
    }
    *slot = __vadd2(best, lane_term);
    slot += LANES + 1;
    if (++r == kTileRows) {
      reduce_tile<LANES>(pr, j - (kTileRows - 1), kTileRows, g, min_split);
      slot = pr.tile + g;
      r = 0;
    }
  }
  if (r) reduce_tile<LANES>(pr, rows - r + 1, r, g, min_split);
}

// every column count a lane of the switches below
#define FOR_COLUMNS(X)                                                     \
  X(1) X(2) X(3) X(4) X(5) X(6) X(7) X(8) X(9) X(10) X(11) X(12) X(13)     \
  X(14) X(15) X(16) X(17) X(18) X(19) X(20) X(21) X(22) X(23) X(24) X(25)  \
  X(26) X(27) X(28) X(29) X(30) X(31) X(32)

// dp_rows<C> for the least C that holds every flank of the warp, C <= CMAX.
template <int CMAX, int LANES>
__device__ __forceinline__ void dp_dispatch(const Pair& pr, int min_split,
                                            int g) {
  const int need =
      __reduce_max_sync(kFull, max(pr.len_lo, pr.len_hi) + 1);
  const int rows = __reduce_max_sync(kFull, pr.n);
#define DP_CASE(K)                                                         \
  case K:                                                                  \
    if constexpr (K <= CMAX) dp_rows<K, LANES>(pr, rows, min_split, g);    \
    break;
  switch ((need + LANES - 1) / LANES) { FOR_COLUMNS(DP_CASE) }
#undef DP_CASE
  __syncwarp();
}

__device__ __forceinline__ unsigned neg4(unsigned ch) {
  return (0u - (ch << 2)) & 0xffffu;
}

// The group's slice of the block's shared memory.
template <int LANES>
__device__ __forceinline__ void carve(unsigned* smem, int L, Pair& pr,
                                      unsigned*& nrd) {
  const int group = threadIdx.x / LANES;
  nrd = smem + group * group_smem_words(L, LANES);
  pr.nrd = nrd;
  pr.rm = nrd + align16(L);
  pr.tile = pr.rm + align16(L + 1);
}

// Two instances a group (2p in the low half, 2p+1 in the high half).
template <int CMAX, int LANES>
__global__ void __launch_bounds__(kWarp * kWarpsPerBlock)
rowmax_kernel(const uint8_t* __restrict__ refs,
              const int* __restrict__ ref_lens, int R,
              const uint8_t* __restrict__ reads,
              const int* __restrict__ read_lens, int L,
              int* __restrict__ out, int B, Scores sc) {
  extern __shared__ __align__(16) unsigned smem[];
  const int g = threadIdx.x % LANES;
  const int64_t pair =
      ((int64_t)blockIdx.x * blockDim.x + threadIdx.x) / LANES;
  const int64_t b0 = 2 * pair;
  // a group past the end stays for the warp's shuffles, on nothing
  const bool one = b0 < B, two = b0 + 1 < B;
  const int64_t i0 = one ? b0 : 0, i1 = two ? b0 + 1 : i0;
  Pair pr;
  unsigned* nrd;
  carve<LANES>(smem, L, pr, nrd);
  const int n0 = one ? min(max(read_lens[i0], 0), L) : 0;
  const int n1 = two ? min(max(read_lens[i1], 0), L) : 0;
  pr.n = max(n0, n1);
  pr.ref_lo = refs + i0 * R;
  pr.ref_hi = refs + i1 * R;
  pr.len_lo = one ? min(max(ref_lens[i0], 0), R) : 0;
  pr.len_hi = two ? min(max(ref_lens[i1], 0), R) : 0;
  const uint8_t* rd0 = reads + i0 * L;
  const uint8_t* rd1 = reads + i1 * L;
  // rows past a group's own count (another group of the warp has more) read
  // zeros
  for (int p = g; p < L; p += LANES)
    nrd[p] = p < pr.n ? neg4(rd0[p]) | (neg4(rd1[p]) << 16) : 0u;
  __syncwarp();
  dp_dispatch<CMAX, LANES>(pr, sc.min_split, g);
  int* row0 = out + i0 * (L + 1);
  int* row1 = out + i1 * (L + 1);
  for (int j = g; j <= L; j += LANES) {
    const unsigned v = j <= pr.n ? pr.rm[j] : 0u;
    if (one) row0[j] = j <= n0 ? lo16(v) : 0;
    if (two) row1[j] = j <= n1 ? hi16(v) : 0;
  }
}

// Two instances a group (2p in the low half, 2p+1 in the high half), as
// rowmax_kernel pairs them; the group's code is tie_rows.cuh's.  Rows come
// from the read as stored, pad included, as in the plain version.
template <int CMAX, int LANES>
__global__ void __launch_bounds__(kWarp * kWarpsPerBlock, 1)
tie_kernel(tie::Args a) {
  extern __shared__ __align__(16) unsigned smem[];
  TIE_PHASE(0);
  const tie::WarpTeam<LANES> t{(int)(threadIdx.x % LANES)};
  const int64_t pair =
      ((int64_t)blockIdx.x * blockDim.x + threadIdx.x) / LANES;
  tie::Pair pr = tie::make_pair(a, pair);
  const tie::Mem s = tie::carve(
      smem + (threadIdx.x / LANES) * tie::group_words(a.L, a.S, a.MC, LANES),
      a.L, a.S, a.MC, LANES);
  const tie::Plan own = tie::prologue<LANES>(t, a, pr, s);
  TIE_PHASE(1);
  // the warp runs its widest flank's columns, to its last captured row
  const tie::Plan warp{__reduce_max_sync(kFull, own.need),
                       __reduce_max_sync(kFull, own.rows),
                       __reduce_max_sync(kFull, own.passes)};
  tie::run_group<CMAX, LANES>(t, a, pr, s, warp);
  TIE_PHASE(6);
}

// One candidate a group: flank 1 and the read in the low half, the reversed
// flank 2 and the reversed read in the high half.
template <int CMAX, int LANES>
__global__ void __launch_bounds__(kWarp * kWarpsPerBlock)
screen_kernel(const uint8_t* __restrict__ uref1,
              const int* __restrict__ ulen1,
              const uint8_t* __restrict__ uref2r,
              const int* __restrict__ ulen2, int R,
              const int* __restrict__ ref_idx,
              const uint8_t* __restrict__ reads,
              const int* __restrict__ read_lens, int L,
              const int* __restrict__ min_scores, int* __restrict__ out,
              int B, Scores sc) {
  extern __shared__ __align__(16) unsigned smem[];
  const int g = threadIdx.x % LANES;
  const int64_t cand =
      ((int64_t)blockIdx.x * blockDim.x + threadIdx.x) / LANES;
  // a group past the end stays for the warp's shuffles, on nothing
  const bool live = cand < B;
  const int64_t b = live ? cand : 0;
  Pair pr;
  unsigned* nrd;
  carve<LANES>(smem, L, pr, nrd);
  // row j of the forward DP reads read[j-1], of the reversed DP read[n-j];
  // rows past a group's own count (another group of the warp has more)
  // read zeros
  const int n = live ? min(max(read_lens[b], 0), L) : 0;
  const uint8_t* rd = reads + b * L;
  for (int p = g; p < L; p += LANES)
    nrd[p] = p < n ? neg4(rd[p]) | (neg4(rd[n - 1 - p]) << 16) : 0u;
  __syncwarp();
  const int64_t k = ref_idx[b];
  pr.n = n;
  pr.ref_lo = uref1 + k * R;
  pr.ref_hi = uref2r + k * R;
  pr.len_lo = live ? min(max(ulen1[k], 0), R) : 0;
  pr.len_hi = live ? min(max(ulen2[k], 0), R) : 0;
  dp_dispatch<CMAX, LANES>(pr, sc.min_split, g);
  // totals[s] = rm1[s] + rm2[n - s]; below the threshold counts as 0
  const int thresh = min_scores[b];
  int best = 0;
  for (int s = g; s <= n; s += LANES) {
    const int t = lo16(pr.rm[s]) + hi16(pr.rm[n - s]);
    if (t >= thresh) best = max(best, t);
  }
#pragma unroll
  for (int d = LANES / 2; d >= 1; d >>= 1)
    best = max(best, __shfl_xor_sync(kFull, best, d, LANES));
  if (g == 0 && live) out[b] = best;
}

// The kernel keeps the scores as compile-time immediates.
inline bool scores_supported(const Scores& sc) {
  return sc.match == 2 && sc.mismatch == -1 && sc.gap == -2;
}

template <typename K>
inline cudaError_t allow_smem(K kernel, size_t bytes) {
  if (bytes <= 48 * 1024) return cudaSuccess;
  return cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
}

struct Shape {
  int lanes, cmax;
};

// Lanes a group and the most columns a lane for flank tables of width R
// (lanes = 0 when R+1 > 1024).  Fewer lanes a group let more candidates
// share a row's shuffles, but the running min is a chain of C dependent
// instructions and a lane's registers grow with C: measured, groups of 8 or
// 16 lanes win while C stays under about 18 and lose badly at C near 30, so
// a group gets the fewest lanes that keep C there.
inline Shape shape_for(int R) {
  const int need = R + 1;
  if (need <= 8 * 16) return {8, 16};
  if (need <= 16 * 18) return {16, 18};
  if (need <= 32 * 16) return {32, 16};
  if (need <= 32 * 32) return {32, 32};
  return {0, 0};
}

inline size_t block_smem(int L, int lanes) {
  return (size_t)(kWarp * kWarpsPerBlock / lanes) *
         group_smem_words(L, lanes) * 4;
}

inline dim3 grid_for(int64_t groups, int lanes) {
  const int per_block = kWarp * kWarpsPerBlock / lanes;
  return dim3((unsigned)((groups + per_block - 1) / per_block));
}

}  // namespace

// every (lanes, most columns a lane) of shape_for
#define FOR_SHAPES(X) X(8, 16) X(16, 18) X(32, 16) X(32, 32)

extern "C" {

// Lanes a group of the screen (8, 16 or 32) for flank tables of width R, or
// 0 when R+1 > 1024; a warp takes the least columns a lane that hold its
// own flanks.
int split_dp_lanes(int R) { return shape_for(R).lanes; }

// rowmax (B, L+1) int32 for per-instance flanks refs (B, R) uint8, two
// instances to a group of shape_for(R) lanes.
int split_dp_rowmax(const void* refs, const void* ref_lens, int R,
                    const void* reads, const void* read_lens, int L,
                    void* out, int B, int match, int mismatch, int gap,
                    int min_split, void* stream) {
  const Scores sc{match, mismatch, gap, min_split};
  const Shape sh = shape_for(R);
  if (!scores_supported(sc) || L > kMaxRead || !sh.lanes)
    return (int)cudaErrorInvalidValue;
  const size_t shmem = block_smem(L, sh.lanes);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const auto* f = static_cast<const uint8_t*>(refs);
  const auto* fl = static_cast<const int*>(ref_lens);
  const auto* r = static_cast<const uint8_t*>(reads);
  const auto* rl = static_cast<const int*>(read_lens);
  auto* o = static_cast<int*>(out);
  const dim3 grid = grid_for(((int64_t)B + 1) / 2, sh.lanes);
  const dim3 block(kWarp * kWarpsPerBlock);
  cudaError_t e = cudaErrorInvalidValue;
#define LAUNCH(LN, CM)                                                      \
  if (sh.lanes == LN && sh.cmax == CM) {                                    \
    e = allow_smem(rowmax_kernel<CM, LN>, shmem);                           \
    if (e == cudaSuccess)                                                   \
      rowmax_kernel<CM, LN><<<grid, block, shmem, st>>>(f, fl, R, r, rl, L, \
                                                        o, B, sc);          \
  }
  FOR_SHAPES(LAUNCH)
#undef LAUNCH
  if (e != cudaSuccess) return (int)e;
  return (int)cudaGetLastError();
}

// Tie columns of the rows row_sel (B, M) int32: rowmax (B, M) int32, the
// anchored max of each row (0 below min_split, and for a slot that names
// no row of the DP: -1, 0 or past L), and packed (B, M, ceil((R+1)/32))
// int32, bit i of word w set where column 32w+i of the row reaches it.
int split_dp_tie_columns(const void* refs, const void* ref_lens, int R,
                         const void* reads, int L, const void* row_sel,
                         int M, void* rowmax, void* packed, int B, int match,
                         int mismatch, int gap, int min_split,
                         void* stream) {
  const Scores sc{match, mismatch, gap, min_split};
  const Shape sh = shape_for(R);
  if (!scores_supported(sc) || L > kMaxRead || !sh.lanes)
    return (int)cudaErrorInvalidValue;
  // slots a group: every row it can capture, up to kTieSlots a pass; the
  // row selections in shared memory: up to kTieSelections a half
  const int S = std::max(1, std::min({2 * M, L, kTieSlots}));
  const int MC = std::min(M, kTieSelections);
  const tie::Args a{static_cast<const uint8_t*>(refs),
                    static_cast<const int*>(ref_lens), R,
                    static_cast<const uint8_t*>(reads), L,
                    static_cast<const int*>(row_sel), M,
                    static_cast<int*>(rowmax), static_cast<int*>(packed),
                    B, S, MC, min_split};
  const size_t shmem = (size_t)(kWarp * kWarpsPerBlock / sh.lanes) *
                       tie::group_words(L, S, MC, sh.lanes) * 4;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const dim3 grid = grid_for(((int64_t)B + 1) / 2, sh.lanes);
  const dim3 block(kWarp * kWarpsPerBlock);
  cudaError_t e = cudaErrorInvalidValue;
#define LAUNCH(LN, CM)                                                      \
  if (sh.lanes == LN && sh.cmax == CM) {                                    \
    e = allow_smem(tie_kernel<CM, LN>, shmem);                              \
    if (e == cudaSuccess) tie_kernel<CM, LN><<<grid, block, shmem, st>>>(a); \
  }
  FOR_SHAPES(LAUNCH)
#undef LAUNCH
  if (e != cudaSuccess) return (int)e;
  return (int)cudaGetLastError();
}

// Fused candidate screen: out (B,) int32 max split score, 0 = reject.
int split_dp_screen(const void* uref1, const void* ulen1, const void* uref2r,
                    const void* ulen2, int R, const void* ref_idx,
                    const void* reads, const void* read_lens, int L,
                    const void* min_scores, void* out, int B, int match,
                    int mismatch, int gap, int min_split, void* stream) {
  const Scores sc{match, mismatch, gap, min_split};
  const Shape sh = shape_for(R);
  if (!scores_supported(sc) || L > kMaxRead || !sh.lanes)
    return (int)cudaErrorInvalidValue;
  const size_t shmem = block_smem(L, sh.lanes);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const auto* u1 = static_cast<const uint8_t*>(uref1);
  const auto* l1 = static_cast<const int*>(ulen1);
  const auto* u2 = static_cast<const uint8_t*>(uref2r);
  const auto* l2 = static_cast<const int*>(ulen2);
  const auto* ix = static_cast<const int*>(ref_idx);
  const auto* r = static_cast<const uint8_t*>(reads);
  const auto* rl = static_cast<const int*>(read_lens);
  const auto* ms = static_cast<const int*>(min_scores);
  auto* o = static_cast<int*>(out);
  const dim3 grid = grid_for(B, sh.lanes), block(kWarp * kWarpsPerBlock);
  cudaError_t e = cudaErrorInvalidValue;
#define LAUNCH(LN, CM)                                                      \
  if (sh.lanes == LN && sh.cmax == CM) {                                    \
    e = allow_smem(screen_kernel<CM, LN>, shmem);                           \
    if (e == cudaSuccess)                                                   \
      screen_kernel<CM, LN><<<grid, block, shmem, st>>>(                    \
          u1, l1, u2, l2, R, ix, r, rl, L, ms, o, B, sc);                   \
  }
  FOR_SHAPES(LAUNCH)
#undef LAUNCH
  if (e != cudaSuccess) return (int)e;
  return (int)cudaGetLastError();
}

#ifdef TIE_PHASE_CLOCK
// The phase clock's stamps (kClockWarps x kPhases int64) into dst.
int tie_phase_clock(void* dst) {
  return (int)cudaMemcpyFromSymbol(dst, tie::clock_at,
                                   sizeof(tie::clock_at));
}
#endif

}  // extern "C"
