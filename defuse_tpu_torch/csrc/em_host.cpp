// The batched EM's row code (em_row.cuh) built for the host, one row after
// another on one thread: what em.cu's kernel computes, in a form the CPU
// tests can run against the plain PyTorch loop.  Same operands as
// em_rows_f64/em_rows_f32 in em.cu, on host memory, without scratch and
// stream.  Build with the host's C++ compiler, without contracting
// products into fused multiply-adds (em.cu is built with --fmad=false), as
// tests/test_torch_em_kernel.py does:
//
//     g++ -std=c++17 -O2 -ffp-contract=off -shared -fPIC
//         -o libem_host.so defuse_tpu_torch/csrc/em_host.cpp

#include <vector>

#include "em_row.cuh"

namespace {

template <typename T>
int run(const void* x, const void* y, const void* u, const void* n,
        const void* k, void* r, void* a, void* b, void* w, void* ll,
        void* done, void* failed, void* it_done, int B, int KM, int N,
        int max_iters, int never, double sigma, double lam, double tol) {
  const em::Batch<T> p = {
      static_cast<const T*>(x), static_cast<const T*>(y),
      static_cast<const T*>(u), static_cast<const int*>(n),
      static_cast<const int*>(k), static_cast<T*>(r), static_cast<T*>(a),
      static_cast<T*>(b), static_cast<T*>(w), static_cast<T*>(ll),
      static_cast<unsigned char*>(done), static_cast<unsigned char*>(failed),
      static_cast<int*>(it_done), B, KM, N, max_iters, never,
      em::make_consts<T>(sigma, lam, tol)};
  std::vector<double> space(em::row_bytes<T>(KM, N, true) / sizeof(double));
  for (int row = 0; row < B; ++row)
    em::process_row(em::HostTeam(), p, row,
                    reinterpret_cast<unsigned char*>(space.data()), true);
  return 0;
}

}  // namespace

extern "C" {

int em_rows_host_f64(const void* x, const void* y, const void* u,
                     const void* n, const void* k, void* r, void* a, void* b,
                     void* w, void* ll, void* done, void* failed,
                     void* it_done, int B, int KM, int N, int max_iters,
                     int never, double sigma, double lam, double tol) {
  return run<double>(x, y, u, n, k, r, a, b, w, ll, done, failed, it_done, B,
                     KM, N, max_iters, never, sigma, lam, tol);
}

int em_rows_host_f32(const void* x, const void* y, const void* u,
                     const void* n, const void* k, void* r, void* a, void* b,
                     void* w, void* ll, void* done, void* failed,
                     void* it_done, int B, int KM, int N, int max_iters,
                     int never, double sigma, double lam, double tol) {
  return run<float>(x, y, u, n, k, r, a, b, w, ll, done, failed, it_done, B,
                    KM, N, max_iters, never, sigma, lam, tol);
}

}  // extern "C"
