// Batched mate-pair EM for Hopper (sm_90a): every (instance, K) row runs
// its EM to the end inside one launch, a block a row.
//
// Replaces the TPU program defuse_tpu/cluster/matepair_em_batch.py::em_run
// (line 453): a jax.lax.while_loop (line 549) inside one jax.jit
// (make_em_step line 557, make_em_slab_step line 566), whose M-step (line
// 233) builds one-hot masks and all-pairs counts because the TPU has no
// fast gather.  Its plain PyTorch version is
// cluster/matepair_em_batch.py::_build_em_run_plain, which drives each
// iteration from the host (~250 small launches an iteration).  What a row
// computes is in em_row.cuh, shared with the host build (em_host.cpp) that
// the CPU tests run.
//
// What bounds it on the card: neither bytes nor operations, but the
// M-step's dependent chain.  A row moves a few kilobytes (its points and
// its (K, N) responsibilities, once in and once out) and does K*n
// exponents and at most 2n merge steps a component an iteration, but each
// merge step waits on the last (a running sum, a compare, a division of
// the derivative) and a component's walk is one thread's.  So:
//
//  * One block a row, kThreads threads.  The row's points, both sort
//    orders, the E-step's terms, the exponents and the responsibilities sit
//    in shared memory for the whole run (33.6 KB at K 10, N 144 in
//    float64).  Where they do not fit, the responsibilities are used in
//    place in the carry and the rest in a scratch row of device memory:
//    every width runs.
//  * The sort is a stable rank count, O(n^2) a row, once a launch.
//  * M-step: one thread a component walks the sequential two-pointer merge
//    of the reference, lazily, and stops at the first rising entry.
//  * E-step: threads over points, components in ascending order; the
//    log-likelihood is warp 0's sum in a fixed order (32 strided partial
//    sums, then a shuffle tree).
//  * The loop never leaves the card: a block ends when its row converges or
//    fails, or at max_iters; no row waits for another.
//  * A row's bits depend only on the row: not on its slab, the padded
//    width, the segments max_iters cuts the run into, or the run.
//
// Measured on an H100 (PERF.md has the numbers): at the bench width the
// merge walk is nearly all of the kernel's time, and the host's slab
// book-keeping around the launches most of run_em's.
//
// Built with --fmad=false (ops/_build.py): each product and sum rounds as
// the plain version's separate tensor operations do.

#include <cuda_runtime.h>

#include "em_row.cuh"

namespace {

constexpr int kThreads = 128;
constexpr unsigned kAllLanes = 0xFFFFFFFFu;

// A block's Team for em_row.cuh.  The host branches exist only so that the
// shared templates compile for both sides; the kernel runs the device ones.
struct BlockTeam {
  EM_HD int rank() const {
#ifdef __CUDA_ARCH__
    return threadIdx.x;
#else
    return 0;
#endif
  }
  EM_HD int size() const {
#ifdef __CUDA_ARCH__
    return blockDim.x;
#else
    return 1;
#endif
  }
  EM_HD void sync() const {
#ifdef __CUDA_ARCH__
    __syncthreads();
#endif
  }
  EM_HD bool any(bool v) const {
#ifdef __CUDA_ARCH__
    return __syncthreads_or(v) != 0;
#else
    return v;
#endif
  }
  // The block's sum of v[0..n): warp 0 adds lane l's points l, l+32, ...
  // and folds the 32 partial sums by halves (HostTeam::ll_sum's order);
  // every thread reads it from `slot` after the barrier.  The next write to
  // slot comes after two more barriers of the loop.
  template <typename T> EM_HD T ll_sum(const T* v, int n, T* slot) const {
#ifdef __CUDA_ARCH__
    if (threadIdx.x < em::kLanes) {
      T part = T(0);
      for (int i = threadIdx.x; i < n; i += em::kLanes) part = part + v[i];
      for (int off = em::kLanes / 2; off > 0; off /= 2)
        part = part + __shfl_down_sync(kAllLanes, part, off);
      if (threadIdx.x == 0) *slot = part;
    }
    __syncthreads();
    return *slot;
#else
    return em::HostTeam().ll_sum(v, n, slot);
#endif
  }
};

// Where a launch keeps each row's arrays: all in shared memory; the
// responsibilities in the carry and the rest in shared memory; or the
// responsibilities in the carry and the rest in `scratch` rows.
struct Plan {
  bool r_inside;
  size_t smem, scratch_row;
};

template <typename T> Plan plan_for(int KM, int N, size_t smem_max) {
  const size_t all = em::row_bytes<T>(KM, N, true);
  if (all <= smem_max) return {true, all, 0};
  const size_t rest = em::row_bytes<T>(KM, N, false);
  if (rest <= smem_max) return {false, rest, 0};
  return {false, 0, rest};
}

// The shared memory a block may opt in to on the current device.
cudaError_t smem_max(size_t* out) {
  int dev = 0, v = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err == cudaSuccess)
    err = cudaDeviceGetAttribute(
        &v, cudaDevAttrMaxSharedMemoryPerBlockOptin, dev);
  *out = (size_t)v;
  return err;
}

template <typename T>
__global__ void __launch_bounds__(kThreads)
    em_rows_kernel(em::Batch<T> p, unsigned char* scratch, size_t scratch_row,
                   bool r_inside) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int row = blockIdx.x;
  unsigned char* base =
      scratch ? scratch + (size_t)row * scratch_row : smem;
  em::process_row(BlockTeam(), p, row, base, r_inside);
}

template <typename T>
int launch(const void* x, const void* y, const void* u, const void* n,
           const void* k, void* r, void* a, void* b, void* w, void* ll,
           void* done, void* failed, void* it_done, void* scratch, int B,
           int KM, int N, int max_iters, int never, double sigma, double lam,
           double tol, void* stream) {
  if (B <= 0) return 0;
  const em::Batch<T> p = {
      static_cast<const T*>(x), static_cast<const T*>(y),
      static_cast<const T*>(u), static_cast<const int*>(n),
      static_cast<const int*>(k), static_cast<T*>(r), static_cast<T*>(a),
      static_cast<T*>(b), static_cast<T*>(w), static_cast<T*>(ll),
      static_cast<unsigned char*>(done), static_cast<unsigned char*>(failed),
      static_cast<int*>(it_done), B, KM, N, max_iters, never,
      em::make_consts<T>(sigma, lam, tol)};
  size_t limit = 0;
  const cudaError_t limit_err = smem_max(&limit);
  if (limit_err != cudaSuccess) return (int)limit_err;
  const Plan plan = plan_for<T>(KM, N, limit);
  if (plan.scratch_row && !scratch) return (int)cudaErrorInvalidValue;
  if (plan.smem > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        em_rows_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        (int)plan.smem);
    if (err != cudaSuccess) return (int)err;
  }
  em_rows_kernel<T><<<B, kThreads, plan.smem,
                      static_cast<cudaStream_t>(stream)>>>(
      p, plan.scratch_row ? static_cast<unsigned char*>(scratch) : nullptr,
      plan.scratch_row, plan.r_inside);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

// Bytes of device scratch a row needs at (KM, N) in float64 (dbl != 0) or
// float32, into *bytes: 0 where its arrays fit in shared memory.  Returns
// the CUDA error code of reading the device's limit.
int em_scratch_row_bytes(int KM, int N, int dbl, long long* bytes) {
  size_t m = 0;
  const cudaError_t err = smem_max(&m);
  *bytes = (long long)(dbl ? plan_for<double>(KM, N, m).scratch_row
                           : plan_for<float>(KM, N, m).scratch_row);
  return (int)err;
}

// Runs B rows of the batched EM in one launch; see em::Batch for the
// operands (n and k int32, done and failed uint8, it_done int32; scratch
// as em_scratch_row_bytes asks, else null).  Returns the launch's CUDA
// error code.
int em_rows_f64(const void* x, const void* y, const void* u, const void* n,
                const void* k, void* r, void* a, void* b, void* w, void* ll,
                void* done, void* failed, void* it_done, void* scratch, int B,
                int KM, int N, int max_iters, int never, double sigma,
                double lam, double tol, void* stream) {
  return launch<double>(x, y, u, n, k, r, a, b, w, ll, done, failed, it_done,
                        scratch, B, KM, N, max_iters, never, sigma, lam, tol,
                        stream);
}

int em_rows_f32(const void* x, const void* y, const void* u, const void* n,
                const void* k, void* r, void* a, void* b, void* w, void* ll,
                void* done, void* failed, void* it_done, void* scratch, int B,
                int KM, int N, int max_iters, int never, double sigma,
                double lam, double tol, void* stream) {
  return launch<float>(x, y, u, n, k, r, a, b, w, ll, done, failed, it_done,
                       scratch, B, KM, N, max_iters, never, sigma, lam, tol,
                       stream);
}

}  // extern "C"
