// The batched EM's row code (em_row.cuh) built for the host, one row after
// another on one thread that plays a warp's lanes in a loop: what em.cu's
// kernel computes, in a form the CPU tests can run against the plain
// PyTorch loop.  Same operands as em_rows_f64/em_rows_f32 in em.cu, on host
// memory, without scratch and stream, and with the row's responsibilities
// copied into its arrays (r_inside != 0) or used in place in the carry, as
// the card's two storage plans do.  Beside the kernel's own entries, two
// for the tests only: whole rows with the M-step walked one thread a
// component (em_rows_walk_host_*), and both M-steps on the same
// responsibilities (em_m_step_host_*, as em.cu's em_m_step_check_*).
// Build with the host's C++ compiler, without contracting products into
// fused multiply-adds (em.cu is built with --fmad=false), as
// tests/test_torch_em_kernel.py does:
//
//     g++ -std=c++17 -O2 -ffp-contract=off -shared -fPIC
//         -o libem_host.so defuse_tpu_torch/csrc/em_host.cpp

#include <vector>

#include "em_row.cuh"

namespace {

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

template <bool kWalk, typename T>
int run(const void* x, const void* y, const void* u, const void* n,
        const void* k, void* r, void* a, void* b, void* w, void* ll,
        void* done, void* failed, void* it_done, int B, int KM, int N,
        int max_iters, int never, double sigma, double lam, double tol,
        int r_inside) {
  const em::Batch<T> p = batch<T>(x, y, u, n, k, r, a, b, w, ll, done,
                                  failed, it_done, B, KM, N, max_iters,
                                  never, sigma, lam, tol);
  std::vector<double> space(em::row_bytes<T>(KM, N, 1, r_inside != 0) /
                            sizeof(double));
  for (int row = 0; row < B; ++row)
    em::process_row<kWalk>(em::HostTeam(), p, row,
                           reinterpret_cast<unsigned char*>(space.data()),
                           r_inside != 0);
  return 0;
}

template <typename T>
int check(const void* x, const void* y, const void* u, const void* n,
          const void* k, void* r, void* a, void* b, void* out, int B, int KM,
          int N, double sigma, double lam) {
  const em::Batch<T> p = batch<T>(x, y, u, n, k, r, a, b, nullptr, nullptr,
                                  nullptr, nullptr, nullptr, B, KM, N, 0, 0,
                                  sigma, lam, 0.0);
  std::vector<double> space(em::row_bytes<T>(KM, N, 1, false) /
                            sizeof(double));
  for (int row = 0; row < B; ++row)
    em::check_row(em::HostTeam(), p, row,
                  reinterpret_cast<unsigned char*>(space.data()),
                  static_cast<T*>(out));
  return 0;
}

}  // namespace

extern "C" {

#define EM_HOST_ROWS(NAME, WALK, T)                                         \
  int NAME(const void* x, const void* y, const void* u, const void* n,      \
           const void* k, void* r, void* a, void* b, void* w, void* ll,     \
           void* done, void* failed, void* it_done, int B, int KM, int N,   \
           int max_iters, int never, double sigma, double lam, double tol,  \
           int r_inside) {                                                  \
    return run<WALK, T>(x, y, u, n, k, r, a, b, w, ll, done, failed,        \
                        it_done, B, KM, N, max_iters, never, sigma, lam,    \
                        tol, r_inside);                                     \
  }

EM_HOST_ROWS(em_rows_host_f64, false, double)
EM_HOST_ROWS(em_rows_host_f32, false, float)
EM_HOST_ROWS(em_rows_walk_host_f64, true, double)
EM_HOST_ROWS(em_rows_walk_host_f32, true, float)

// Both M-steps of every row on r, a and b (B, KM, N; B, KM), unchanged:
// out (6, B, KM) holds the walk's a, b, nk, then the warp form's.
int em_m_step_host_f64(const void* x, const void* y, const void* u,
                       const void* n, const void* k, void* r, void* a,
                       void* b, void* out, int B, int KM, int N,
                       double sigma, double lam) {
  return check<double>(x, y, u, n, k, r, a, b, out, B, KM, N, sigma, lam);
}

int em_m_step_host_f32(const void* x, const void* y, const void* u,
                       const void* n, const void* k, void* r, void* a,
                       void* b, void* out, int B, int KM, int N,
                       double sigma, double lam) {
  return check<float>(x, y, u, n, k, r, a, b, out, B, KM, N, sigma, lam);
}

}  // extern "C"
