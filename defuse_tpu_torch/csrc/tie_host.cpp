// The tie kernel's group code (tie_rows.cuh) built for the host: one thread
// plays each group's lanes in a loop, warp after warp, with the warp's plan
// (columns, last row, passes) taken over its groups as the card's
// reductions take it.  What split_dp.cu's tie_kernel computes, in a form
// the CPU tests can run against the JAX and the plain PyTorch
// dp_tie_columns.  Same operands as split_dp_tie_columns, on host memory,
// with the group shape (lanes, most columns a lane: a pair of split_dp.cu's
// shape_for), the slots a pass and the row selections kept in shared
// memory given, so that a test can run every shape, force several passes
// and read selections past the shared ones from row_sel.  Build with the
// host's C++ compiler, as tests/test_torch_tie_kernel.py does:
//
//     g++ -std=c++17 -O2 -shared -fPIC -o libtie_host.so
//         defuse_tpu_torch/csrc/tie_host.cpp

#include <algorithm>
#include <vector>

#include "tie_rows.cuh"

namespace {

constexpr int kWarp = 32;

template <int CMAX, int LANES>
void run(const tie::Args& a) {
  constexpr int kGroups = kWarp / LANES;
  const tie::HostTeam<LANES> t;
  const int64_t pairs = ((int64_t)a.B + 1) / 2;
  const int words = tie::group_words(a.L, a.S, a.MC, LANES);
  std::vector<unsigned> smem((size_t)kGroups * words);
  for (int64_t p0 = 0; p0 < pairs; p0 += kGroups) {
    tie::Pair pr[kGroups];
    tie::Mem s[kGroups];
    tie::Plan warp{0, 0, 0};
    for (int q = 0; q < kGroups; ++q) {
      pr[q] = tie::make_pair(a, p0 + q);
      s[q] = tie::carve(smem.data() + q * words, a.L, a.S, a.MC, LANES);
      const tie::Plan own = tie::prologue<LANES>(t, a, pr[q], s[q]);
      warp.need = std::max(warp.need, own.need);
      warp.rows = std::max(warp.rows, own.rows);
      warp.passes = std::max(warp.passes, own.passes);
    }
    for (int q = 0; q < kGroups; ++q)
      tie::run_group<CMAX, LANES>(t, a, pr[q], s[q], warp);
  }
}

}  // namespace

extern "C" {

// rowmax (B, M) and packed (B, M, ceil((R+1)/32)) int32 as
// split_dp_tie_columns writes them, for groups of `lanes` lanes of at most
// `cmax` columns (8/16, 16/18, 32/16 or 32/32; lanes * cmax >= R + 1),
// `slots` captured rows a pass and the first `selections` (at most M) row
// selections of a half kept in shared memory.  Returns 0, or -1 for a
// shape it lacks.
int tie_columns_host(const void* refs, const void* ref_lens, int R,
                     const void* reads, int L, const void* row_sel, int M,
                     void* rowmax, void* packed, int B, int min_split,
                     int lanes, int cmax, int slots, int selections) {
  const tie::Args a{static_cast<const uint8_t*>(refs),
                    static_cast<const int*>(ref_lens), R,
                    static_cast<const uint8_t*>(reads), L,
                    static_cast<const int*>(row_sel), M,
                    static_cast<int*>(rowmax), static_cast<int*>(packed),
                    B, slots, selections, min_split};
  if (slots < 1 || selections < 0 || selections > M || lanes * cmax < R + 1)
    return -1;
  if (lanes == 8 && cmax == 16) return run<16, 8>(a), 0;
  if (lanes == 16 && cmax == 18) return run<18, 16>(a), 0;
  if (lanes == 32 && cmax == 16) return run<16, 32>(a), 0;
  if (lanes == 32 && cmax == 32) return run<32, 32>(a), 0;
  return -1;
}

}  // extern "C"
