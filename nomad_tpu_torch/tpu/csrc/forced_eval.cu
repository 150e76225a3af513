// Forced-node system kernel, both arms: one thread per placement.
//
// Replaces the XLA program of nomad_tpu/tpu/engine.py:888-997
// (_build_forced_kernel, K4). When every placement of a system eval names
// a distinct forced node and the eval carries no evictions, spreads,
// affinities, reschedule penalties, distinct_property or preemption (the
// system encoder's shape), the scan's steps are independent: no step
// touches another step's node and each has at most one candidate. So the
// eval is one elementwise pass over the placement axis: the node's fit,
// distinct_hosts and feature lane, then binpack + anti-affinity, with the
// same arithmetic as the scan step (common.cuh) in the same order, so the
// result equals the placement scan's (place_scan.cu) bit for bit:
//   int   (forced_eval_launch, T = int32_t): Q27 e_base * e_ask >> 27, Q30
//         binpack, the Q45 reciprocal of the desired count, score60;
//   float (forced_eval_f32_launch, T = float): pow(10, free) binpack and
//         -(count + 1) / desired, each operation rounded alone, and the
//         zero terms the scan adds (reschedule, affinity, spread) added
//         the same way.
// Padded placements carry forced_node = -1 and come out chosen = -1.
//
// What bounds it on an H100: not the card. The work is about 80 bytes
// per placement (the node's capacity, usage and counts rows, its feature
// byte and two Q27 factors) and a few dozen operations, ~0.4 MB at
// P = 5,000: ~0.13 us at 3.35 TB/s. What a system eval pays is the launch
// (a few microseconds) and the two copies around it, so the design takes
// away everything else: the wrapper (kernels.forced_eval_packed) reads the
// 16 input arrays from ONE packed buffer that came over in one pinned copy
// (kernels.pack_forced_inputs), passes pointers into it (no tensor per
// array), writes chosen and scores into one output buffer brought back in
// one copy, and makes the constant pulls / skipped / evict on the host.
// P is taken as it is (no bucket pad). A block of 128 threads spreads
// P = 5,000 over 40 SMs; n_real is read once per block; each placement's
// gather (its node's rows, its task group's flags) sits in one place,
// through the read-only cache. A CUDA graph would not help: one launch
// whose P changes from eval to eval has nothing to replay.

#include <cstdint>
#include <cuda_runtime.h>

#include "common.cuh"

using namespace nomad;

// Mirrors ForcedArgs in kernels.py field for field (ints first, then
// pointers). Arrays marked T hold int32 in the int arm and float32 in the
// float arm; S holds int64 and float32 respectively; bools are bytes.
struct ForcedArgs {
  int P, N, D, G, has_reserved;
  const void* totals;          // T [N,D]
  const void* reserved;        // T [N,D] when has_reserved
  const void* asks;            // T [G,D]
  const uint8_t* feat;         // [G,N] bit0 feasible
  const int32_t* desired;      // [G]
  const uint8_t* dh_job;       // [G]
  const uint8_t* dh_tg;        // [G]
  const int32_t* n_real;       // [1]
  const int32_t* e_ask;        // [G,N,2] int arm
  const void* used;            // T [N,D]
  const int32_t* tg_counts;    // [G,N]
  const int32_t* job_counts;   // [N]
  const uint8_t* failed;       // [G]
  const int32_t* e_base;       // [N,2] int arm
  const int32_t* tg_idx;       // [P]
  const int32_t* forced_node;  // [P]
  int32_t* chosen;             // [P]
  void* scores;                // S [P]
};

namespace {

template <typename T> struct ScoreOf;
template <> struct ScoreOf<int32_t> { using type = long long; };
template <> struct ScoreOf<float> { using type = float; };

constexpr int kThreads = 128;

template <typename T>
__global__ void __launch_bounds__(kThreads) forced_eval_kernel(const ForcedArgs a) {
  using Score = typename ScoreOf<T>::type;
  constexpr bool kFloat = sizeof(Score) == 4;
  __shared__ int s_n_real;
  if (threadIdx.x == 0) s_n_real = __ldg(a.n_real);
  __syncthreads();
  const int p = blockIdx.x * blockDim.x + threadIdx.x;
  if (p >= a.P) return;
  const int N = a.N, D = a.D;
  const T* totals = static_cast<const T*>(a.totals);
  const T* reserved = a.has_reserved ? static_cast<const T*>(a.reserved) : nullptr;
  const T* asks = static_cast<const T*>(a.asks);
  const T* used = static_cast<const T*>(a.used);
  Score* scores = static_cast<Score*>(a.scores);

  const int j = __ldg(a.forced_node + p);
  const int g = __ldg(a.tg_idx + p);
  if (j < 0 || j >= s_n_real || __ldg(a.failed + g)) {
    a.chosen[p] = -1;
    scores[p] = (Score)0;
    return;
  }
  // the gather: the task group's flags, the node's counts and feature
  // byte, in the int arm its two Q27 factor rows, then its capacity rows
  // dim by dim
  const int desired = __ldg(a.desired + g);
  const bool dh_job = __ldg(a.dh_job + g), dh_tg = __ldg(a.dh_tg + g);
  const int jc = __ldg(a.job_counts + j);
  const int tgc = __ldg(a.tg_counts + (size_t)g * N + j);
  const uint8_t feat = __ldg(a.feat + (size_t)g * N + j);
  int32_t eb[2] = {0, 0}, ea[2] = {0, 0};
  if constexpr (!kFloat) {
    for (int d = 0; d < 2; ++d) {
      eb[d] = __ldg(a.e_base + j * 2 + d);
      ea[d] = __ldg(a.e_ask + ((size_t)g * N + j) * 2 + d);
    }
  }
  bool fits = true;
  T util_cm[2] = {(T)0, (T)0}, tot_cm[2] = {(T)0, (T)0}, res_cm[2] = {(T)0, (T)0};
  for (int d = 0; d < D; ++d) {
    const T tot = __ldg(totals + j * D + d);
    const T res = reserved ? __ldg(reserved + j * D + d) : (T)0;
    const T ask = __ldg(asks + g * D + d);
    T util = __ldg(used + j * D + d);
    if constexpr (kFloat) {
      // (used + reserved) + ask, engine.py:922
      if (reserved) util = __fadd_rn(util, res);
      util = __fadd_rn(util, ask);
    } else {
      util += ask;
      if (reserved) util += res;
    }
    if (d < 2) {
      util_cm[d] = util;
      tot_cm[d] = tot;
      res_cm[d] = res;
    }
    fits = fits && util <= tot;
  }

  const bool dh = dh_job ? (jc == 0) : (dh_tg ? !(tgc > 0 && jc > 0) : true);
  const bool feasible = (feat & 1) && fits && dh;
  const bool anti_present = tgc > 0;
  Score final_score;
  if constexpr (kFloat) {
    const float node_c = reserved ? __fsub_rn(tot_cm[0], res_cm[0]) : tot_cm[0];
    const float node_m = reserved ? __fsub_rn(tot_cm[1], res_cm[1]) : tot_cm[1];
    const float binpack = binpack_f32(util_cm[0], util_cm[1], node_c, node_m);
    const float anti = anti_f32(anti_present, tgc, (float)desired);
    // the scan's sum with its zero reschedule, affinity and spread terms
    float sum = __fadd_rn(binpack, anti);
    sum = __fadd_rn(sum, 0.f);
    sum = __fadd_rn(sum, 0.f);
    sum = __fadd_rn(sum, 0.f);
    final_score = __fdiv_rn(sum, (float)(1 + (int)anti_present));
  } else {
    const long long desired_g = desired > 1 ? desired : 1;
    const long long q_d = (1LL << kRecipBits) / desired_g;
    // e_sel of the gathered rows (node 0 of a one-node row)
    const long long binpack = binpack_q30(e_sel(eb, ea, 0, 0), e_sel(eb, ea, 0, 1));
    const long long anti = anti_q30(anti_present, tgc, q_d);
    final_score = (binpack + anti) * (long long)(60 / (1 + (int)anti_present));
  }
  a.chosen[p] = feasible ? j : -1;
  scores[p] = feasible ? final_score : (Score)0;
}

template <typename T>
int launch(const ForcedArgs* args, void* stream) {
  if (args->P == 0) return 0;
  const int blocks = (args->P + kThreads - 1) / kThreads;
  forced_eval_kernel<T><<<blocks, kThreads, 0, (cudaStream_t)stream>>>(*args);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" int forced_eval_launch(const ForcedArgs* args, void* stream) {
  return launch<int32_t>(args, stream);
}

extern "C" int forced_eval_f32_launch(const ForcedArgs* args, void* stream) {
  return launch<float>(args, stream);
}

extern "C" const char* forced_eval_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}

extern "C" int forced_eval_args_size() { return (int)sizeof(ForcedArgs); }
