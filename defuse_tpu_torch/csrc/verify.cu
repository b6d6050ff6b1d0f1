// Packed candidate verification for Hopper (sm_90a): a group of 8, 16 or
// 32 lanes per candidate placement, one window word a lane.
//
// Replaces the TPU program defuse_tpu/ops/verify_batch.py::_verify_packed3
// (line 86; an XLA program in plain jnp), the device stage of the aligner
// frontend's SeedIndex.verify.  Integer-exact with
// ops/verify_batch.verify_packed3_ref.
//
// Layout (ops/verify_batch.pack_codes3): 10 bases of 3 bits per 32-bit word
// (A C G T N = 0..4, base i of a word at bits [3i, 3i+3)), bits 30 and 31
// zero.  A candidate start s arrives as (word10, lane10) = (s / 10, s % 10),
// int32 and uint8; reads are packed the same way, one row of
// W = ceil(L / 10) words each.  Window word k is cut out of plane words
// word10+k and word10+k+1, both clamped to the last word as the reference
// clamps its gather: lo >> 3*lane10 | hi << (30 - 3*lane10), masked to 30
// bits.  The shift is in [3, 30] and needs no branch, because bits 30 and 31
// are zero.  The XOR with the read word is zero in every matching 3-bit
// group, so N == N matches; each group is OR-folded to its low bit, masked
// to the read's valid bases in that word, and counted with __popc.
//
// What bounds it on the card: bytes.  A 100 bp candidate needs 44 B of the
// plane and 40 B of its read for some 110 integer operations, and a genome's
// plane (1.24 GB for 3.1 Gbp) does not fit the 50 MB L2, so the windows come
// from device memory in 32 B sectors at unrelated addresses.  What the
// kernel can lose beside the bytes is load instructions that touch many
// sectors each, and too few of them in flight.  So:
//
//  * A warp takes 32 consecutive candidates.  Each lane streams one
//    candidate's word10, lane10 and read_idx (three coalesced loads a warp,
//    __ldcs: read once, not kept in cache) and gathers its read's length;
//    the values reach the lanes that need them by shuffle.
//  * A candidate is verified by a group of G lanes, G = 8, 16 or 32, the
//    least that holds its W + 1 plane words (picked on the host from W;
//    a warp-uniform template parameter).  Lane k loads plane word word10+k
//    and read word k: one request of one or two sectors per candidate and
//    operand, 32/G candidates per load instruction.  Lane k's upper word is
//    lane k+1's lower word (__shfl_down_sync), so each plane word is loaded
//    once.
//  * A group has kInFlight candidates in flight: the loads of all of them
//    are issued before any of their arithmetic.
//  * The lanes' shares of those kInFlight counts are summed together: a
//    butterfly that halves each lane's values at every level, then one
//    value around the rest of the group (3 + log2(G / 4) shuffles for four
//    candidates, where a sum per candidate and a shuffle to hand it to its
//    lane take 4 * (log2(G) + 1)).  Step j's
//    count ends on lane j of its group, and the warp's 32 counts leave in
//    one streaming store of one 128 B line (__stcs).
//  * Reads of more than 310 bases (W + 1 > 32) take verify_wide_kernel: a
//    warp per candidate, lane k walking words k, k+32, ... and loading both
//    of its plane words.
//
// Two more variants of each kernel, behind the LEG template flag, split its
// time into its two resources (ops/verify_roofline.py): kGatherLeg does only
// the two gathers and sums what it loaded into a checksum; kComputeLeg does
// all the arithmetic on loads from fixed addresses (plane words 0..W, read
// row 0), which the compiler takes out of the loop.
//
// Measured on an H100 (PERF.md has the numbers): on a genome's plane the
// gather leg takes as long as the kernel, which moves its 32 B sectors at
// about the rate device memory gives scattered reads; on a plane that fits
// L2 with candidates sorted by read, the kernel is bound by its ~12
// instructions a 50 bp candidate, of which 5 of a group's 8 lanes do useful
// words.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kWarp = 32;
constexpr unsigned kAllLanes = 0xFFFFFFFFu;
constexpr uint32_t kWordMask = 0x3FFFFFFFu;   // bits 0..29
constexpr uint32_t kGroupLow = 0x09249249u;   // bit 0 of each 3-bit group
constexpr int kBasesPerWord = 10;
constexpr int kInFlight = 4;   // candidates a group has in flight: 2^n <= 8

enum Leg { kFullLeg = 0, kGatherLeg = 1, kComputeLeg = 2 };

struct Operands {
  const uint32_t* ref3;
  uint32_t last;   // index of the plane's last word
  const int* word10;
  const uint8_t* lane10;
  const uint32_t* reads3;
  int W;
  const int* read_idx;
  const int* read_lens;
  int* out;
  int C;
};

// Mismatches in window word k of a read of len bases: lo and hi are the
// plane words that hold the window, sh = 3 * lane10.
__device__ __forceinline__ int word_mismatches(uint32_t lo, uint32_t hi,
                                               uint32_t sh, uint32_t rd,
                                               int len, int k) {
  const uint32_t win = ((lo >> sh) | (hi << (30u - sh))) & kWordMask;
  const uint32_t x = win ^ rd;
  const uint32_t t = (x | (x >> 1) | (x >> 2)) & kGroupLow;
  const int v = min(max(len - kBasesPerWord * k, 0), kBasesPerWord);
  return __popc(t & ((1u << (3 * v)) - 1u));
}

// One candidate of the warp's 32 a lane: (word10, 3 * lane10, read_idx,
// read length), zeros past the last candidate.
struct Candidate {
  int w0, sh, r, len;
};

template <int LEG>
__device__ __forceinline__ Candidate load_candidate(const Operands& p,
                                                    int64_t i) {
  Candidate c = {0, 0, 0, 0};
  if (i < p.C) {
    c.w0 = __ldcs(p.word10 + i);
    c.sh = 3 * (int)__ldcs(p.lane10 + i);
    c.r = __ldcs(p.read_idx + i);
  }
  c.len = __ldg(p.read_lens + (LEG == kComputeLeg ? 0 : c.r));
  return c;
}

template <int G, int LEG>
__global__ void __launch_bounds__(kThreads)
verify_group_kernel(const Operands p) {
  constexpr int kGroups = kWarp / G;   // candidates a warp verifies at once
  const int lane = threadIdx.x & (kWarp - 1);
  const int k = lane & (G - 1);        // this lane's window word
  const int g = lane / G;              // its group
  const int64_t i = (int64_t)blockIdx.x * kThreads + threadIdx.x;
  const Candidate mine = load_candidate<LEG>(p, i);
  const int mine_len_sh = (mine.len << 5) | mine.sh;   // sh <= 27
  const bool in_plane = k <= p.W, in_read = k < p.W;
  int result = 0;

  // Unrolled twice: rolled, it ran 7% slower on candidates sorted by
  // read; fully unrolled, 1% to 4% slower on a genome's plane.
#pragma unroll 2
  for (int j0 = 0; j0 < G; j0 += kInFlight) {
    uint32_t lo[kInFlight], rd[kInFlight];
    int w0[kInFlight], v[kInFlight];
#pragma unroll
    for (int u = 0; u < kInFlight; ++u) {
      // step j verifies the warp's candidates j * kGroups + g
      const int src = (j0 + u) * kGroups + g;
      w0[u] = __shfl_sync(kAllLanes, mine.w0, src);
      const int r = __shfl_sync(kAllLanes, mine.r, src);
      // word indices fit 32 bits (checked on the host): one add, one min
      // and one widening multiply-add an address
      const uint32_t w = LEG == kComputeLeg ? k : (uint32_t)w0[u] + k;
      const uint32_t row = LEG == kComputeLeg ? 0u : (uint32_t)r * p.W;
      lo[u] = in_plane ? __ldg(p.ref3 + min(w, p.last)) : 0u;
      rd[u] = in_read ? __ldg(p.reads3 + (row + k)) : 0u;
    }
#pragma unroll
    for (int u = 0; u < kInFlight; ++u) {
      const int src = (j0 + u) * kGroups + g;
      const int len_sh = __shfl_sync(kAllLanes, mine_len_sh, src);
      const int sh = len_sh & 31;
      if (LEG == kGatherLeg) {
        v[u] = (int)(lo[u] + rd[u]) + (k == 0 ? sh / 3 : 0);
      } else {
        const uint32_t hi = __shfl_down_sync(kAllLanes, lo[u], 1, G);
        v[u] = in_read ? word_mismatches(lo[u], hi, sh, rd[u], len_sh >> 5,
                                         k) : 0;
        if (LEG == kComputeLeg && k == 0) v[u] += w0[u];
      }
    }
    // Sum the kInFlight steps over the group.  First a butterfly among
    // each kInFlight neighbouring lanes, which halves a lane's values at
    // every level (a lane keeps the half that its bit of k names and adds
    // its partner's share): lane k then holds step j0 + k % kInFlight.
    // Then the one value left goes around the rest of the group.
#pragma unroll
    for (int half = kInFlight / 2; half > 0; half >>= 1) {
      const bool upper = (k & half) != 0;
#pragma unroll
      for (int m = 0; m < half; ++m) {
        const int send = upper ? v[m] : v[m + half];
        const int keep = upper ? v[m + half] : v[m];
        v[m] = keep + __shfl_xor_sync(kAllLanes, send, half);
      }
    }
#pragma unroll
    for (int d = kInFlight; d < G; d <<= 1)
      v[0] += __shfl_xor_sync(kAllLanes, v[0], d);
    // lane k of a group keeps the count of the group's step k
    if ((k & ~(kInFlight - 1)) == j0) result = v[0];
  }
  const int64_t c = i - lane + k * kGroups + g;
  if (c < p.C) __stcs(p.out + c, result);
}

template <int LEG>
__global__ void __launch_bounds__(kThreads)
verify_wide_kernel(const Operands p) {
  const int lane = threadIdx.x & (kWarp - 1);
  const int64_t i = (int64_t)blockIdx.x * kThreads + threadIdx.x;
  const Candidate mine = load_candidate<LEG>(p, i);
  int result = 0;

  for (int j = 0; j < kWarp; ++j) {
    const int w0 = __shfl_sync(kAllLanes, mine.w0, j);
    const int sh = __shfl_sync(kAllLanes, mine.sh, j);
    const int r = __shfl_sync(kAllLanes, mine.r, j);
    const int len = __shfl_sync(kAllLanes, mine.len, j);
    const uint32_t base = LEG == kComputeLeg ? 0u : (uint32_t)w0;
    const uint32_t row = LEG == kComputeLeg ? 0u : (uint32_t)r * p.W;
    int v = 0;
    for (int k = lane; k < p.W; k += kWarp) {
      const uint32_t w = base + k;
      const uint32_t lo = __ldg(p.ref3 + min(w, p.last));
      const uint32_t hi = __ldg(p.ref3 + min(w + 1, p.last));
      const uint32_t rd = __ldg(p.reads3 + (row + k));
      if (LEG == kGatherLeg)
        v += (int)(lo + rd + (k == p.W - 1 ? hi : 0u));
      else
        v += word_mismatches(lo, hi, sh, rd, len, k);
    }
    if (lane == 0) {
      if (LEG == kGatherLeg) v += sh / 3;
      if (LEG == kComputeLeg) v += w0;
    }
#pragma unroll
    for (int d = kWarp / 2; d > 0; d >>= 1)
      v += __shfl_xor_sync(kAllLanes, v, d);
    if (lane == j) result = v;
  }
  if (i < p.C) __stcs(p.out + i, result);
}

// Lanes a candidate's group has for rows of W words (the window's words
// and the one past them); 0 where a warp walks the row.
int group_lanes(int W) {
  return W + 1 <= 8 ? 8 : W + 1 <= 16 ? 16 : W + 1 <= 32 ? 32 : 0;
}

template <int LEG>
void launch_leg(const Operands& p, dim3 grid, cudaStream_t stream) {
  switch (group_lanes(p.W)) {
    case 8:
      verify_group_kernel<8, LEG><<<grid, kThreads, 0, stream>>>(p);
      break;
    case 16:
      verify_group_kernel<16, LEG><<<grid, kThreads, 0, stream>>>(p);
      break;
    case 32:
      verify_group_kernel<32, LEG><<<grid, kThreads, 0, stream>>>(p);
      break;
    default:
      verify_wide_kernel<LEG><<<grid, kThreads, 0, stream>>>(p);
  }
}

}  // namespace

extern "C" {

// The group width launch_leg picks for rows of W words; 0 for the wide kernel.
int verify_group_lanes(int W) { return group_lanes(W); }

// Mismatch counts (C,) int32 of C candidate placements.  ref3 (n_words,)
// and reads3 (B, W) are packed 30-bit words; word10 and read_idx (C,) and
// read_lens (B,) int32, lane10 (C,) uint8.  Indices are trusted, and both
// arrays hold fewer than 2^31 words (checked on the host).  leg: 0 the
// counts, 1 the gather leg's checksums, 2 the compute leg's.
int verify_packed3(const void* ref3, long long n_words, const void* word10,
                   const void* lane10, const void* reads3, int W,
                   const void* read_idx, const void* read_lens, void* out,
                   int C, int leg, void* stream) {
  if (C <= 0) return 0;
  if (leg < 0 || leg > 2) return (int)cudaErrorInvalidValue;
  const Operands p = {static_cast<const uint32_t*>(ref3),
                      (uint32_t)(n_words - 1),
                      static_cast<const int*>(word10),
                      static_cast<const uint8_t*>(lane10),
                      static_cast<const uint32_t*>(reads3),
                      W,
                      static_cast<const int*>(read_idx),
                      static_cast<const int*>(read_lens),
                      static_cast<int*>(out),
                      C};
  const dim3 grid((unsigned)(((long long)C + kThreads - 1) / kThreads));
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (leg == kGatherLeg) launch_leg<kGatherLeg>(p, grid, s);
  else if (leg == kComputeLeg) launch_leg<kComputeLeg>(p, grid, s);
  else launch_leg<kFullLeg>(p, grid, s);
  return (int)cudaGetLastError();
}

}  // extern "C"
