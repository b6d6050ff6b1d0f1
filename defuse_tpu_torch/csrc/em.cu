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
// M-step's dependent chains.  A row moves a few kilobytes (its points and
// its (K, N) responsibilities, once in and once out) and does K*n
// exponents and at most 2n merge steps a component an iteration; the
// merge's sums are folds, one term at a time, and the path stops at its
// first rising entry.  The rows that run longest set the kernel's time,
// each iteration waiting on its M-step.  So:
//
//  * One block a row, warps_for(KM) warps.  The row's points, both sort
//    orders and their value runs, the E-step's terms, the exponents, the
//    responsibilities and the M-step's running sums sit in shared memory
//    for the whole run (72 KB at K 10, N 141 in float64, three rows an
//    SM).  Where they do not fit, the responsibilities are used in place
//    in the carry and the rest in a scratch row of device memory: every
//    width runs.  Each of the three plans is an instantiation of its own,
//    so that shared memory is addressed as such.
//  * The sort is a stable rank count, O(n^2) a row, once a launch, and the
//    value runs of both orders are marked once after it.
//  * M-step, in two parts.  The sums first: two threads a component, each
//    folding two sums one term at a time (nk or the numerator in point
//    order, the running sum in x- or y-sorted order, kept at each run's
//    end with its rank among equal sums), all components at once; only the
//    fp64 adds are on a fold's chain.  Then a warp a component places the
//    merge path's steps 32 diagonals at a time, each lane its diagonal's by
//    a binary search over those sums (a merge path), and tests the steps'
//    entries on its lanes at once (the division kept); ballots find the
//    first rising one.  The same entries, sums and stop as the reference's
//    walk (em_row.cuh, m_step_walk), so the same bits; em_m_step_check
//    runs both on the card.
//  * E-step: threads over points, components in ascending order; the
//    log-likelihood is warp 0's sum in a fixed order (32 strided partial
//    sums, then a shuffle tree).
//  * The loop never leaves the card: a block ends when its row converges or
//    fails, or at max_iters; no row waits for another.
//  * A row's bits depend only on the row: not on its slab, the padded
//    width, the segments max_iters cuts the run into, or the run.
//
// Measured on an H100 (PERF.md has the numbers): at the bench width the
// kernel takes 3.0-3.5 ms against 5.1-5.7 ms with one thread walking each
// component, the M-step 61% of a row-iteration's cycles (its folds two
// thirds of that); the host's slab book-keeping around the launches is
// most of run_em's time.
//
// Built with --fmad=false (ops/_build.py): each product and sum rounds as
// the plain version's separate tensor operations do.

#include <cuda_runtime.h>

#include "em_row.cuh"

namespace {

constexpr int kMaxWarps = 8;
constexpr unsigned kAllLanes = 0xFFFFFFFFu;

// The warps of a row's block: one a component up to kMaxWarps.
int warps_for(int KM) { return KM < 1 ? 1 : KM < kMaxWarps ? KM : kMaxWarps; }

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
  EM_HD int warp() const {
#ifdef __CUDA_ARCH__
    return threadIdx.x / em::kLanes;
#else
    return 0;
#endif
  }
  EM_HD int warps() const {
#ifdef __CUDA_ARCH__
    return blockDim.x / em::kLanes;
#else
    return 1;
#endif
  }
  // Every lane of the warp calls it, with the same pred.
  template <int kBits, typename F>
  EM_HD void ballots(F pred, unsigned* mask) const {
#ifdef __CUDA_ARCH__
    const unsigned v = pred(threadIdx.x % em::kLanes);
    for (int b = 0; b < kBits; ++b)
      mask[b] = __ballot_sync(kAllLanes, v >> b & 1u);
#else
    em::HostTeam().ballots<kBits>(pred, mask);
#endif
  }
  EM_HD void warp_sync() const {
#ifdef __CUDA_ARCH__
    __syncwarp();
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

// Where a launch keeps each row's arrays: all in shared memory (kShared);
// the responsibilities in the carry and the rest in shared memory
// (kCarry); or the responsibilities in the carry and the rest in `scratch`
// rows (kScratch).  Each is an instantiation of its own, so that the
// compiler knows the arrays that lie in shared memory and addresses them
// there.
enum Where { kShared, kCarry, kScratch };

struct Plan {
  int where;
  size_t smem, scratch_row;
};

template <typename T> Plan plan_for(int KM, int N, size_t smem_max) {
  const int warps = warps_for(KM);
  const size_t all = em::row_bytes<T>(KM, N, warps, true);
  if (all <= smem_max) return {kShared, all, 0};
  const size_t rest = em::row_bytes<T>(KM, N, warps, false);
  if (rest <= smem_max) return {kCarry, rest, 0};
  return {kScratch, 0, rest};
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

template <int kWhere>
__device__ unsigned char* row_base(unsigned char* smem,
                                   unsigned char* scratch,
                                   size_t scratch_row) {
  return kWhere == kScratch ? scratch + (size_t)blockIdx.x * scratch_row
                            : smem;
}

template <typename T, int kWhere>
__global__ void __launch_bounds__(kMaxWarps * em::kLanes)
    em_rows_kernel(em::Batch<T> p, unsigned char* scratch,
                   size_t scratch_row, T*) {
  extern __shared__ __align__(16) unsigned char smem[];
  em::process_row<false>(BlockTeam(), p, blockIdx.x,
                         row_base<kWhere>(smem, scratch, scratch_row),
                         kWhere == kShared);
}

// For the checks only: both M-steps of each row on the batch's r, a, b
// (em_row.cuh, check_row; r stays in the carry), with em_rows_kernel's
// geometry and storage.
template <typename T, int kWhere>
__global__ void __launch_bounds__(kMaxWarps * em::kLanes)
    em_m_step_check_kernel(em::Batch<T> p, unsigned char* scratch,
                           size_t scratch_row, T* out) {
  extern __shared__ __align__(16) unsigned char smem[];
  em::check_row(BlockTeam(), p, blockIdx.x,
                row_base<kWhere>(smem, scratch, scratch_row), out);
}

template <typename T>
using Kernel = void (*)(em::Batch<T>, unsigned char*, size_t, T*);

// Launches B rows of the kernel of the plan that (KM, N) needs, one for
// each Where; returns the CUDA error code of planning or launching.
template <typename T>
int start(const Kernel<T> (&kernels)[3], const em::Batch<T>& p,
          void* scratch, T* out, void* stream) {
  if (p.B <= 0) return 0;
  size_t limit = 0;
  cudaError_t err = smem_max(&limit);
  if (err != cudaSuccess) return (int)err;
  const Plan plan = plan_for<T>(p.KM, p.N, limit);
  if (plan.scratch_row && !scratch) return (int)cudaErrorInvalidValue;
  const Kernel<T> kernel = kernels[plan.where];
  if (plan.smem > 48 * 1024) {
    err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)plan.smem);
    if (err != cudaSuccess) return (int)err;
  }
  kernel<<<p.B, warps_for(p.KM) * em::kLanes, plan.smem,
           static_cast<cudaStream_t>(stream)>>>(
      p, plan.scratch_row ? static_cast<unsigned char*>(scratch) : nullptr,
      plan.scratch_row, out);
  return (int)cudaGetLastError();
}

template <typename T>
em::Batch<T> batch(const void* x, const void* y, const void* u,
                   const void* n, const void* k, void* r, void* a, void* b,
                   void* w, void* ll, void* done, void* failed,
                   void* it_done, int B, int KM, int N, int max_iters,
                   int never, double sigma, double lam, double tol) {
  return {static_cast<const T*>(x), static_cast<const T*>(y),
          static_cast<const T*>(u), static_cast<const int*>(n),
          static_cast<const int*>(k), static_cast<T*>(r), static_cast<T*>(a),
          static_cast<T*>(b), static_cast<T*>(w), static_cast<T*>(ll),
          static_cast<unsigned char*>(done),
          static_cast<unsigned char*>(failed), static_cast<int*>(it_done), B,
          KM, N, max_iters, never, em::make_consts<T>(sigma, lam, tol)};
}

template <typename T>
int launch(const void* x, const void* y, const void* u, const void* n,
           const void* k, void* r, void* a, void* b, void* w, void* ll,
           void* done, void* failed, void* it_done, void* scratch, int B,
           int KM, int N, int max_iters, int never, double sigma, double lam,
           double tol, void* stream) {
  static const Kernel<T> kernels[3] = {em_rows_kernel<T, kShared>,
                                       em_rows_kernel<T, kCarry>,
                                       em_rows_kernel<T, kScratch>};
  return start<T>(kernels,
                  batch<T>(x, y, u, n, k, r, a, b, w, ll, done, failed,
                           it_done, B, KM, N, max_iters, never, sigma, lam,
                           tol),
                  scratch, nullptr, stream);
}

template <typename T>
int launch_check(const void* x, const void* y, const void* u, const void* n,
                 const void* k, void* r, void* a, void* b, void* out,
                 void* scratch, int B, int KM, int N, double sigma,
                 double lam, void* stream) {
  static const Kernel<T> kernels[3] = {em_m_step_check_kernel<T, kCarry>,
                                       em_m_step_check_kernel<T, kCarry>,
                                       em_m_step_check_kernel<T, kScratch>};
  return start<T>(kernels,
                  batch<T>(x, y, u, n, k, r, a, b, nullptr, nullptr, nullptr,
                           nullptr, nullptr, B, KM, N, 0, 0, sigma, lam, 0.0),
                  scratch, static_cast<T*>(out), stream);
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

// For the checks only: both M-steps of every row on r, a and b (unchanged)
// into out (6, B, KM): the walk's a, b, nk, then the warp form's; scratch
// as em_scratch_row_bytes asks.  Returns the launch's CUDA error code.
int em_m_step_check_f64(const void* x, const void* y, const void* u,
                        const void* n, const void* k, void* r, void* a,
                        void* b, void* out, void* scratch, int B, int KM,
                        int N, double sigma, double lam, void* stream) {
  return launch_check<double>(x, y, u, n, k, r, a, b, out, scratch, B, KM,
                              N, sigma, lam, stream);
}

int em_m_step_check_f32(const void* x, const void* y, const void* u,
                        const void* n, const void* k, void* r, void* a,
                        void* b, void* out, void* scratch, int B, int KM,
                        int N, double sigma, double lam, void* stream) {
  return launch_check<float>(x, y, u, n, k, r, a, b, out, scratch, B, KM, N,
                             sigma, lam, stream);
}

}  // extern "C"
