// Packed candidate verification for Hopper (sm_90a): one thread per
// candidate placement.
//
// Replaces the TPU program defuse_tpu/ops/verify_batch.py::_verify_packed3
// (line 86; an XLA program in plain jnp), the device stage of the aligner
// frontend's SeedIndex.verify.  Integer-exact with
// ops/verify_batch.verify_packed3_ref.
//
// Layout (ops/verify_batch.pack_codes3): 10 bases of 3 bits per 32-bit word
// (A C G T N = 0..4, base i of a word at bits [3i, 3i+3)), bits 30 and 31
// zero.  A candidate start s arrives as (word10, lane10) = (s / 10, s % 10);
// reads are packed the same way, one row of W = ceil(L / 10) words each.
// For window word k the kernel reads plane words word10+k and word10+k+1,
// both clamped to the last word as the reference clamps its gather, and
// shifts the window out of them: lo >> 3*lane | hi << (30 - 3*lane), masked
// to 30 bits.  The shift is in [3, 30] for lanes 0..9 and needs no branch,
// because bits 30 and 31 are zero (the 30-bit words are why this is two
// shifts and not one __funnelshift_r).  The XOR with the read word is zero
// in every matching 3-bit group, so N == N matches; each group is OR-folded
// to its low bit, masked to the read's valid bases in that word, and
// counted with __popc.
//
// What bounds it on the card: gather transactions, not arithmetic.  A 50 bp
// candidate reads 6 plane words (24 B) and 5 read words (20 B) at random
// addresses for about 2 integer instructions per base.  The design keeps
// each candidate in one thread, walks its window words in order and carries
// the upper plane word into the next step, so each plane word is loaded
// once.  At the microbench's shape (4,000,000 bases) the 1.6 MB plane sits
// in the 50 MB L2; a 3.1 Gbp genome's plane is 1.24 GB and its gathers go
// to device memory.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr uint32_t kWordMask = 0x3FFFFFFFu;   // bits 0..29
constexpr uint32_t kGroupLow = 0x09249249u;   // bit 0 of each 3-bit group
constexpr int kBasesPerWord = 10;

__global__ void __launch_bounds__(kThreads)
verify_kernel(const uint32_t* __restrict__ ref3, int64_t n_words,
              const int* __restrict__ word10, const int* __restrict__ lane10,
              const uint32_t* __restrict__ reads3, int W,
              const int* __restrict__ read_idx,
              const int* __restrict__ read_lens, int* __restrict__ out,
              int C) {
  const int64_t i = (int64_t)blockIdx.x * kThreads + threadIdx.x;
  if (i >= C) return;
  const int64_t last = n_words - 1;
  const int64_t w0 = word10[i];
  const uint32_t sh = 3u * (uint32_t)lane10[i];
  const int64_t r = read_idx[i];
  const int len = read_lens[r];
  const uint32_t* rd = reads3 + r * W;

  uint32_t lo = __ldg(ref3 + (w0 < last ? w0 : last));
  int count = 0;
  for (int k = 0; k < W; ++k) {
    const int64_t w = w0 + k + 1;
    const uint32_t hi = __ldg(ref3 + (w < last ? w : last));
    const uint32_t win = ((lo >> sh) | (hi << (30u - sh))) & kWordMask;
    const uint32_t x = win ^ __ldg(rd + k);
    const uint32_t t = (x | (x >> 1) | (x >> 2)) & kGroupLow;
    const int v = min(max(len - kBasesPerWord * k, 0), kBasesPerWord);
    const uint32_t valid = (1u << (3 * v)) - 1u;
    count += __popc(t & valid);
    lo = hi;
  }
  out[i] = count;
}

}  // namespace

extern "C" {

// Mismatch counts (C,) int32 of C candidate placements.  ref3 (n_words,)
// and reads3 (B, W) are packed 30-bit words; word10, lane10, read_idx (C,)
// and read_lens (B,) int32.  Indices are trusted (checked on the host).
int verify_packed3(const void* ref3, long long n_words, const void* word10,
                   const void* lane10, const void* reads3, int W,
                   const void* read_idx, const void* read_lens, void* out,
                   int C, void* stream) {
  if (C <= 0) return 0;
  const dim3 grid((unsigned)((C + kThreads - 1) / kThreads));
  verify_kernel<<<grid, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint32_t*>(ref3), (int64_t)n_words,
      static_cast<const int*>(word10), static_cast<const int*>(lane10),
      static_cast<const uint32_t*>(reads3), W,
      static_cast<const int*>(read_idx), static_cast<const int*>(read_lens),
      static_cast<int*>(out), C);
  return (int)cudaGetLastError();
}

}  // extern "C"
