// Issue-rate probe for Hopper (sm_90a): the sustained cost of one warp
// instruction of each class the split-DP screen issues.
//
// Replaces the TPU kernel defuse_tpu/ops/split_dp_census.py::vpu_peak_probe
// (its inner `kernel`, line 143), which saturated the TPU's vector unit
// with independent roll/add/max chains to price the screen's census.
//
// Every thread runs kStreams independent int32 chains, each step of which
// depends on the last, in one of six mixes (template MIX):
//   alu    max and min of a stream pair, then an add to each: VIMNMX and
//          an integer add, which max-then-add keeps out of the DPX fusion;
//   dpx    __viaddmax_s32 on a cross-linked pair (the TPU probe's
//          body_alu): one VIADDMNMX each;
//   shfl   __viaddmax_s32(a, 1, __shfl_up_sync(a, 1)): one SHFL and one
//          VIADDMNMX each, the counterpart of body_roll's lane-crossing
//          roll;
//   redux  __reduce_max_sync(a + lane): one integer add and one REDUX each;
//   alu16  the alu mix on both int16 halves of the register (__vmaxs2,
//          __vmins2, __vadd2): VIMNMX.S16x2 and VIADD.16x2;
//   dpx16  the dpx mix on both halves (__viaddmax_s16x2): one
//          VIADDMNMX.S16x2 each.  The screen's row loop is made of these
//          two; their chains start from 12 bits a half so that the check
//          run stays inside int16 (the timed run wraps, which costs the
//          same).
// The streams are cross-linked or cross lanes, so nothing folds to a closed
// form, and each thread writes the max of its chains, so nothing is dead.
// The step loop is unrolled kUnroll times inside a loop kept rolled, so
// the static loop body is kUnroll steps plus the loop's own control.
//
// What bounds it: nothing but issue and the pipe each class runs on.  The
// chains live in registers and touch memory once at each end.  The wrapper
// launches 2048 resident threads (64 warps) per SM on every SM, 16 warps
// per scheduler, enough independent chains to hide each pipe's latency;
// the time of a step is then the cost of its instructions.  Timing two
// iteration counts and taking the difference cancels launch and the
// chains' set-up (ops/split_dp_census.issue_peak_probe).

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kStreams = 4;
constexpr int kUnroll = 16;
constexpr unsigned kFull = 0xffffffffu;

enum Mix : int { kAlu = 0, kDpx = 1, kShfl = 2, kRedux = 3, kAlu16 = 4, kDpx16 = 5 };

template <int MIX>
__device__ __forceinline__ void step(int (&a)[kStreams], int lane) {
#pragma unroll
  for (int s = 0; s < kStreams; s += 2) {
    const int x = a[s], y = a[s + 1];
    if constexpr (MIX == kAlu) {
      a[s] = max(x, y) + 1;
      a[s + 1] = min(x, y) + 2;
    } else if constexpr (MIX == kDpx) {
      a[s] = __viaddmax_s32(x, 1, y);
      a[s + 1] = __viaddmax_s32(y, 2, x);
    } else if constexpr (MIX == kShfl) {
      a[s] = __viaddmax_s32(x, 1, __shfl_up_sync(kFull, x, 1));
      a[s + 1] = __viaddmax_s32(y, 1, __shfl_up_sync(kFull, y, 1));
    } else if constexpr (MIX == kRedux) {
      a[s] = __reduce_max_sync(kFull, x + lane);
      a[s + 1] = __reduce_max_sync(kFull, y + lane);
    } else if constexpr (MIX == kAlu16) {
      a[s] = __vadd2(__vmaxs2(x, y), 0x00010001u);
      a[s + 1] = __vadd2(__vmins2(x, y), 0x00020002u);
    } else {
      a[s] = __viaddmax_s16x2(x, 0x00010001u, y);
      a[s + 1] = __viaddmax_s16x2(y, 0x00020002u, x);
    }
  }
}

template <int MIX>
__global__ void __launch_bounds__(kThreads)
probe_kernel(const int* __restrict__ seed, int iters, int* __restrict__ out) {
  const int64_t t = (int64_t)blockIdx.x * kThreads + threadIdx.x;
  const int lane = threadIdx.x % 32;
  int a[kStreams];
#pragma unroll
  for (int s = 0; s < kStreams; ++s)
    a[s] = (MIX >= kAlu16 ? seed[t] & 0x0fff0fff : seed[t]) + s;
#pragma unroll 1
  for (int j = 0; j < iters; j += kUnroll) {
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) step<MIX>(a, lane);
  }
  int m = a[0];
#pragma unroll
  for (int s = 1; s < kStreams; ++s) m = max(m, a[s]);
  out[t] = m;
}

}  // namespace

extern "C" {

// out[t] = max of thread t's chains after `iters` steps (a multiple of
// kUnroll) of mix `mix` (0 alu, 1 dpx, 2 shfl, 3 redux, 4 alu16, 5 dpx16),
// started at seed[t] + s (the 16x2 mixes at (seed[t] & 0x0fff0fff) + s).
// seed and out hold blocks * 256 int32.
int issue_probe(const void* seed, int iters, int mix, void* out, int blocks,
                void* stream) {
  if (blocks <= 0) return 0;
  if (iters < 0 || iters % kUnroll) return (int)cudaErrorInvalidValue;
  const auto* s = static_cast<const int*>(seed);
  auto* o = static_cast<int*>(out);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (mix) {
    case kAlu: probe_kernel<kAlu><<<blocks, kThreads, 0, st>>>(s, iters, o); break;
    case kDpx: probe_kernel<kDpx><<<blocks, kThreads, 0, st>>>(s, iters, o); break;
    case kShfl: probe_kernel<kShfl><<<blocks, kThreads, 0, st>>>(s, iters, o); break;
    case kRedux: probe_kernel<kRedux><<<blocks, kThreads, 0, st>>>(s, iters, o); break;
    case kAlu16: probe_kernel<kAlu16><<<blocks, kThreads, 0, st>>>(s, iters, o); break;
    case kDpx16: probe_kernel<kDpx16><<<blocks, kThreads, 0, st>>>(s, iters, o); break;
    default: return (int)cudaErrorInvalidValue;
  }
  return (int)cudaGetLastError();
}

}  // extern "C"
