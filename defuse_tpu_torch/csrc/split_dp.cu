// Split-read DP for Hopper (sm_90a): one warp per (flank, read) instance.
//
// Replaces the TPU kernel defuse_tpu/ops/split_dp_pallas.py::_dp_kernel,
// and, in the screen entry, also the flank gather, read reversal and
// combine that _screen_candidates wraps around it.
//
// Recurrence (integer, bit-exact with ops/split_dp_batch.dp_row_maxima):
// DP column i = 0..R holds ref position i-1 (column 0 is the boundary).
// Row 0 is all zeros (free start in the flank).  For read row j:
//   vert[0] = GAP*j
//   vert[i] = max(prev[i-1] + (ref[i-1]==read[j-1] ? MATCH : MISMATCH),
//                 prev[i] + GAP)
//   col[i]  = max(vert[i], col[i-1] + GAP)          (horizontal gap)
// rowmax[j] is the max of col over i <= ref_len, set to 0 below
// MIN_SPLIT_SCORE and for rows j > read_len.
//
// What bounds it on the card: INT32 issue and warp shuffles, not bytes.
// A 100 bp read against a 480 bp flank is ~48k cell updates of ~10 integer
// instructions each, from ~600 bytes of input.  The design spends no
// memory traffic between rows: a warp owns one instance, lane t keeps the
// contiguous chunk of C columns [t*C, t*C+C) and the flank characters for
// them in registers for the whole row loop.  Per row, the only cross-lane
// traffic is one __shfl_up_sync for the diagonal neighbour, a 5-step
// log-scan of the chunk tails (the horizontal gap is a prefix max with
// linear decay, so partial maxima combine with a known decay) and one
// __reduce_max_sync for the row max.  The TPU kernel's lane padding,
// circular rolls, one-hot character extraction and int16 path have no
// counterpart here.  Each warp walks only its own read length.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kWarp = 32;
constexpr int kWarpsPerBlock = 4;
constexpr unsigned kFull = 0xffffffffu;
constexpr int kNeg = -(1 << 30);

struct Scores {
  int match, mismatch, gap, min_split;
};

__host__ __device__ inline int align16(int x) { return (x + 15) & ~15; }

// One DP instance on the calling warp.  `read` lies in shared memory and
// holds n characters; REVERSE walks it backwards (the screen's second DP
// runs the reversed read against the reversed second flank).  Lane 0
// writes rm[0..n]; rm may be shared or global memory.
template <int C, bool REVERSE>
__device__ __forceinline__ void dp_instance(const uint8_t* __restrict__ ref,
                                            int ref_len,
                                            const uint8_t* read, int n,
                                            Scores sc, int lane, int* rm) {
  const int base = lane * C;
  int rc[C];
  int prev[C];
#pragma unroll
  for (int c = 0; c < C; ++c) {
    const int i = base + c;
    rc[c] = (i >= 1 && i <= ref_len) ? (int)ref[i - 1] : 0;
    prev[c] = 0;
  }
  if (lane == 0) rm[0] = 0;

  for (int j = 1; j <= n; ++j) {
    const int ch = REVERSE ? read[n - j] : read[j - 1];
    // previous row's last column of the lane to the left (diagonal input)
    const int left = __shfl_up_sync(kFull, prev[C - 1], 1);
    // vertical step in place, right to left so prev[c-1] is still old
#pragma unroll
    for (int c = C - 1; c >= 0; --c) {
      const int diag = (c == 0) ? left : prev[c - 1];
      const int sub = (rc[c] == ch) ? sc.match : sc.mismatch;
      prev[c] = max(diag + sub, prev[c] + sc.gap);
    }
    if (lane == 0) prev[0] = sc.gap * j;
    // horizontal gap within the chunk
#pragma unroll
    for (int c = 1; c < C; ++c) prev[c] = max(prev[c], prev[c - 1] + sc.gap);
    // inclusive scan of chunk tails across lanes: tail_t becomes the best
    // value reaching column t*C+C-1 from any lane s <= t
    int tail = prev[C - 1];
#pragma unroll
    for (int d = 1; d < kWarp; d <<= 1) {
      const int up = __shfl_up_sync(kFull, tail, d);
      if (lane >= d) tail = max(tail, up + sc.gap * C * d);
    }
    // value carried into this lane's first column from the lanes before it
    int carry = __shfl_up_sync(kFull, tail, 1) + sc.gap;
    if (lane == 0) carry = kNeg;
    int best = kNeg;
#pragma unroll
    for (int c = 0; c < C; ++c) {
      prev[c] = max(prev[c], carry + sc.gap * c);
      if (base + c <= ref_len) best = max(best, prev[c]);
    }
    best = __reduce_max_sync(kFull, best);
    if (lane == 0) rm[j] = best >= sc.min_split ? best : 0;
  }
}

// Stage the warp's read into its shared-memory slot; returns the clamped
// read length.
__device__ __forceinline__ int stage_read(const uint8_t* __restrict__ reads,
                                          const int* __restrict__ read_lens,
                                          int64_t b, int L, uint8_t* s_read,
                                          int lane) {
  const int n = min(max(read_lens[b], 0), L);
  const uint8_t* rd = reads + b * L;
  for (int p = lane; p < n; p += kWarp) s_read[p] = rd[p];
  __syncwarp();
  return n;
}

template <int C>
__global__ void __launch_bounds__(kWarp * kWarpsPerBlock)
rowmax_kernel(const uint8_t* __restrict__ refs,
              const int* __restrict__ ref_lens, int R,
              const uint8_t* __restrict__ reads,
              const int* __restrict__ read_lens, int L,
              int* __restrict__ out, int B, Scores sc) {
  extern __shared__ __align__(16) uint8_t smem[];
  const int warp = threadIdx.x / kWarp, lane = threadIdx.x % kWarp;
  const int64_t b = (int64_t)blockIdx.x * kWarpsPerBlock + warp;
  if (b >= B) return;  // whole warp leaves together
  uint8_t* s_read = smem + warp * align16(L);
  const int n = stage_read(reads, read_lens, b, L, s_read, lane);
  int* row = out + b * (L + 1);
  dp_instance<C, false>(refs + b * R, min(ref_lens[b], R), s_read, n, sc,
                        lane, row);
  for (int j = n + 1 + lane; j <= L; j += kWarp) row[j] = 0;
}

template <int C>
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
  extern __shared__ __align__(16) uint8_t smem[];
  const int warp = threadIdx.x / kWarp, lane = threadIdx.x % kWarp;
  const int64_t b = (int64_t)blockIdx.x * kWarpsPerBlock + warp;
  if (b >= B) return;
  const int stride = align16(L) + 2 * align16(4 * (L + 1));
  uint8_t* s_read = smem + warp * stride;
  int* rm1 = reinterpret_cast<int*>(s_read + align16(L));
  int* rm2 = reinterpret_cast<int*>(s_read + align16(L) +
                                    align16(4 * (L + 1)));
  const int n = stage_read(reads, read_lens, b, L, s_read, lane);
  const int64_t k = ref_idx[b];
  dp_instance<C, false>(uref1 + k * R, min(ulen1[k], R), s_read, n, sc, lane,
                        rm1);
  dp_instance<C, true>(uref2r + k * R, min(ulen2[k], R), s_read, n, sc, lane,
                       rm2);
  __syncwarp();
  // totals[s] = rm1[s] + rm2[n - s]; below the threshold counts as 0
  const int thresh = min_scores[b];
  int best = 0;
  for (int s = lane; s <= n; s += kWarp) {
    const int t = rm1[s] + rm2[n - s];
    if (t >= thresh) best = max(best, t);
  }
  best = __reduce_max_sync(kFull, best);
  if (lane == 0) out[b] = best;
}

inline dim3 grid_for(int B) {
  return dim3((unsigned)((B + kWarpsPerBlock - 1) / kWarpsPerBlock));
}

}  // namespace

extern "C" {

// Columns per lane for a flank width R: the smallest C in {4,8,16,32} with
// 32*C >= R+1, or 0 when R+1 > 1024.
int split_dp_cols_per_lane(int R) {
  for (int c = 4; c <= 32; c *= 2)
    if (kWarp * c >= R + 1) return c;
  return 0;
}

// rowmax (B, L+1) int32 for per-instance flanks refs (B, R) uint8.
int split_dp_rowmax(const void* refs, const void* ref_lens, int R,
                    const void* reads, const void* read_lens, int L,
                    void* out, int B, int match, int mismatch, int gap,
                    int min_split, void* stream) {
  const Scores sc{match, mismatch, gap, min_split};
  const size_t shmem = (size_t)kWarpsPerBlock * align16(L);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const auto* f = static_cast<const uint8_t*>(refs);
  const auto* fl = static_cast<const int*>(ref_lens);
  const auto* r = static_cast<const uint8_t*>(reads);
  const auto* rl = static_cast<const int*>(read_lens);
  auto* o = static_cast<int*>(out);
  const dim3 grid = grid_for(B), block(kWarp * kWarpsPerBlock);
  switch (split_dp_cols_per_lane(R)) {
    case 4: rowmax_kernel<4><<<grid, block, shmem, st>>>(f, fl, R, r, rl, L, o, B, sc); break;
    case 8: rowmax_kernel<8><<<grid, block, shmem, st>>>(f, fl, R, r, rl, L, o, B, sc); break;
    case 16: rowmax_kernel<16><<<grid, block, shmem, st>>>(f, fl, R, r, rl, L, o, B, sc); break;
    case 32: rowmax_kernel<32><<<grid, block, shmem, st>>>(f, fl, R, r, rl, L, o, B, sc); break;
    default: return (int)cudaErrorInvalidValue;
  }
  return (int)cudaGetLastError();
}

// Fused candidate screen: out (B,) int32 max split score, 0 = reject.
int split_dp_screen(const void* uref1, const void* ulen1, const void* uref2r,
                    const void* ulen2, int R, const void* ref_idx,
                    const void* reads, const void* read_lens, int L,
                    const void* min_scores, void* out, int B, int match,
                    int mismatch, int gap, int min_split, void* stream) {
  const Scores sc{match, mismatch, gap, min_split};
  const size_t shmem = (size_t)kWarpsPerBlock *
                       (align16(L) + 2 * align16(4 * (L + 1)));
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
  const dim3 grid = grid_for(B), block(kWarp * kWarpsPerBlock);
  switch (split_dp_cols_per_lane(R)) {
    case 4: screen_kernel<4><<<grid, block, shmem, st>>>(u1, l1, u2, l2, R, ix, r, rl, L, ms, o, B, sc); break;
    case 8: screen_kernel<8><<<grid, block, shmem, st>>>(u1, l1, u2, l2, R, ix, r, rl, L, ms, o, B, sc); break;
    case 16: screen_kernel<16><<<grid, block, shmem, st>>>(u1, l1, u2, l2, R, ix, r, rl, L, ms, o, B, sc); break;
    case 32: screen_kernel<32><<<grid, block, shmem, st>>>(u1, l1, u2, l2, R, ix, r, rl, L, ms, o, B, sc); break;
    default: return (int)cudaErrorInvalidValue;
  }
  return (int)cudaGetLastError();
}

}  // extern "C"
