// Chunked throughput scan (K5), float arm: one thread block per eval.
//
// Replaces the XLA program of nomad_tpu/tpu/engine.py:3033-3210
// (_build_chunk_scan): each step places up to K instances of one task
// group on the top-K scoring distinct feasible nodes, with a per-TG
// deficit carry that rolls a chunk's shortfall into the TG's later steps.
// The JAX program is pure; here the carry (used, tg_counts, job_counts,
// spread_counts) and the deficit are updated IN PLACE in device memory,
// and the wrapper (kernels.py) returns the same tensors.
//
// Shape of the work. The steps depend on each other through the carry,
// so the T steps run in order inside one block (the loop replaces
// lax.scan); run_chunked launches one eval at a time (grid = 1). A step:
//   1. score pass: each thread scores nodes tid, tid + T, ... (fit,
//      distinct_hosts, binpack, anti-affinity, affinity, targeted spread,
//      engine.py:3079-3166) and writes a 32-bit order-preserving key of
//      the masked score to a scratch row (IEEE total order: -inf below
//      every finite value, -0 below +0, the order lax.top_k sorts in);
//   2. threshold: the K-th largest key by a block-wide radix select, four
//      8-bit digit passes, each a 256-bin shared-memory histogram and a
//      block scan from the top bin down; it leaves the count of keys
//      strictly above the threshold key;
//   3. ties at the threshold: the lowest node indices among keys equal to
//      it, by a block prefix count over tiles in natural node order;
//      every selected (key, index) pair goes to shared memory;
//   4. order: a bitonic sort of the K pairs as 64-bit composites (~key
//      high, index low; pow2 >= K entries, at most 4,096 = 32 KB), i.e.
//      key descending, then index ascending: lax.top_k's tie order;
//   5. validity, placed and the deficit (engine.py:3169-3173), then the
//      carry update from the chosen nodes: used, tg_counts and job_counts
//      without atomics (the nodes are distinct), spread_counts[g,s,v] by
//      atomicAdd of 1.0f (exact in f32 below 2**24, in any order).
// The slots past want_eff still carry the next-best nodes, as in JAX:
// top_idx is compared over all K slots.
//
// Float arithmetic: every operation rounds on its own (__f*_rn, never
// contracted into FMA) in the JAX program's order, pow(10, x) is powf
// (the function torch.pow calls on the card), big = finfo(f32).max / 16,
// final = ((binpack + anti) + affinity) + spread_total, spread terms
// summed over s = 0..S-1 in index order. The score is recovered from the
// key (the map is a bijection), so no score row is kept.
//
// What bounds it on an H100: not bytes or operations (one C1M run at
// N = 5,120, ~1,430 steps, moves a few hundred MB of L2-resident rows
// and does ~10^9 operations) but the steps' chains of block-wide
// barriers on ONE SM: four histogram passes, the tie pass's tile scans
// and the sort's log2(L)(log2(L)+1)/2 stages per step. Thread-block
// clusters over the node axis and keys kept in shared memory are later
// work.

#include <cstdint>
#include <cuda_runtime.h>
#include <cub/block/block_scan.cuh>

#include "common.cuh"

using namespace nomad;

namespace {

constexpr int kThreads = 512;
constexpr int kMaxK = 4096;
constexpr float kF32Big = 3.40282347e+38f / 16.0f;  // finfo(f32).max / 16

}  // namespace

// Mirrors ChunkArgs in kernels.py field for field (ints first, then
// pointers). Bools are bytes. reserved is full height (the chunk gate's
// "folded reserved" refuses the rest).
struct ChunkArgs {
  int N, D, G, S, V, T, K, has_aff;
  // static
  const float* totals;              // [N,D]
  const float* reserved;            // [N,D]
  const float* asks;                // [G,D]
  const uint8_t* feat;              // [G,N] bit0 feasible, bit1 affinity
  const float* aff_score;           // [G,N] when has_aff
  const int32_t* desired;           // [G]
  const uint8_t* dh_job;            // [G]
  const uint8_t* dh_tg;             // [G]
  const int32_t* spread_vids;       // [G,S,N]
  const float* spread_desired;      // [G,S,V]
  const float* spread_weights;      // [G,S]
  const uint8_t* spread_active;     // [G,S]
  const float* sum_spread_weights;  // [G]
  const int32_t* n_real;            // scalar
  // carry and deficit (updated in place)
  float* used;                      // [N,D]
  int32_t* tg_counts;               // [G,N]
  int32_t* job_counts;              // [N]
  float* spread_counts;             // [G,S,V]
  int32_t* deficit;                 // [G]
  // per step
  const int32_t* tg_idx;            // [T]
  const int32_t* want;              // [T]
  // outputs
  int32_t* top_idx;                 // [T,K]
  float* top_scores;                // [T,K]
  uint8_t* valid;                   // [T,K]
  int32_t* placed;                  // [T]
  // scratch
  uint32_t* keys;                   // [N]
};

namespace {

__device__ __forceinline__ uint32_t f32_key(float f) {
  const uint32_t b = __float_as_uint(f);
  return (b & 0x80000000u) ? ~b : (b | 0x80000000u);
}

__device__ __forceinline__ float key_f32(uint32_t k) {
  return __uint_as_float((k & 0x80000000u) ? (k & 0x7FFFFFFFu) : ~k);
}

// The masked score of node i for one ask of task group g.
__device__ __forceinline__ float masked_score(const ChunkArgs& a, int g, int i, int n_real) {
  const int N = a.N, D = a.D, S = a.S, V = a.V;
  const float* ask = a.asks + (size_t)g * D;
  bool fits = true;
  float util_c = 0.f, util_m = 0.f;
  for (int d = 0; d < D; ++d) {
    // (used + reserved) + ask, engine.py:3093
    const float u = __fadd_rn(__fadd_rn(a.used[(size_t)i * D + d], a.reserved[(size_t)i * D + d]),
                              ask[d]);
    if (d == 0) util_c = u;
    if (d == 1) util_m = u;
    fits = fits && u <= a.totals[(size_t)i * D + d];
  }
  const int tgc = a.tg_counts[(size_t)g * N + i];
  const int jc = a.job_counts[i];
  const bool dh = a.dh_job[g] ? (jc == 0) : (a.dh_tg[g] ? !(tgc > 0 && jc > 0) : true);
  const uint8_t fb = a.feat[(size_t)g * N + i];
  const bool feasible = (fb & 1) && fits && dh && i < n_real;
  if (!feasible) return -INFINITY;

  const float node_c = __fsub_rn(a.totals[(size_t)i * D + 0], a.reserved[(size_t)i * D + 0]);
  const float node_m = __fsub_rn(a.totals[(size_t)i * D + 1], a.reserved[(size_t)i * D + 1]);
  const float binpack = binpack_f32(util_c, util_m, node_c, node_m);
  const bool anti_present = tgc > 0;
  const float anti = anti_f32(anti_present, tgc, (float)a.desired[g]);
  const bool aff_p = a.has_aff && ((fb >> 1) & 1);
  const float aff = aff_p ? a.aff_score[(size_t)g * N + i] : 0.f;

  // targeted spread (engine.py:3122-3151); the chunk step reads no
  // spread_has_targets
  const float sum_sw = max_keep_nan(a.sum_spread_weights[g], kEps);
  float spread_total = 0.f;
  for (int s = 0; s < S; ++s) {
    const size_t row = (size_t)g * S + s;
    float per = 0.f;
    if (a.spread_active[row]) {
      const int vid = a.spread_vids[row * N + i];
      const bool inr = vid >= 0 && vid < V;
      const float used_count = __fadd_rn(inr ? a.spread_counts[row * V + vid] : 0.f, 1.f);
      const float dd = inr ? a.spread_desired[row * V + vid] : 0.f;
      if (vid == V - 1) {
        per = -1.f;
      } else if (dd > 0.f) {
        const float wf = __fdiv_rn(a.spread_weights[row], sum_sw);
        per = __fmul_rn(__fdiv_rn(__fsub_rn(dd, used_count), dd), wf);
      } else {
        per = dd == 0.f ? -kF32Big : -1.f;
      }
    }
    spread_total = __fadd_rn(spread_total, per);
  }
  const int num_terms = 1 + (int)anti_present + (int)aff_p + (int)(spread_total != 0.f);
  float sum = __fadd_rn(binpack, anti);
  sum = __fadd_rn(sum, aff);
  sum = __fadd_rn(sum, spread_total);
  return __fdiv_rn(sum, (float)num_terms);
}

__global__ void __launch_bounds__(kThreads) chunk_scan_kernel(const ChunkArgs a) {
  using Scan = cub::BlockScan<int, kThreads>;
  __shared__ typename Scan::TempStorage scan_tmp;
  __shared__ int s_hist[256];
  __shared__ int s_bin, s_above, s_n, s_placed;
  extern __shared__ unsigned long long s_sort[];  // [L]

  const int tid = threadIdx.x;
  const int N = a.N, D = a.D, S = a.S, V = a.V, K = a.K;
  int L = 1;
  while (L < K) L <<= 1;
  const int n_real = a.n_real[0];

  for (int t = 0; t < a.T; ++t) {
    // every thread reads the step's scalars; the previous step's writes
    // were fenced by the barrier that ended it
    const int g = a.tg_idx[t];
    const int want_total = a.want[t] + a.deficit[g];
    const int want_eff = want_total < K ? want_total : K;

    // -- 1. score pass ----------------------------------------------------
    for (int i = tid; i < N; i += kThreads) a.keys[i] = f32_key(masked_score(a, g, i, n_real));
    __syncthreads();

    // -- 2. the K-th largest key: radix select, 8 bits a pass ---------------
    uint32_t prefix = 0;
    int rest = K;  // how many of the K still lie at or below the prefix
    for (int pass = 0; pass < 4; ++pass) {
      const int shift = 24 - 8 * pass;
      const uint32_t hi_mask = pass == 0 ? 0u : (0xFFFFFFFFu << (shift + 8));
      for (int j = tid; j < 256; j += kThreads) s_hist[j] = 0;
      __syncthreads();
      for (int i = tid; i < N; i += kThreads) {
        const uint32_t k = a.keys[i];
        if ((k & hi_mask) == prefix) atomicAdd(&s_hist[(k >> shift) & 255u], 1);
      }
      __syncthreads();
      // bins from the top: thread j holds bin 255 - j
      const int h = tid < 256 ? s_hist[255 - tid] : 0;
      int incl;
      Scan(scan_tmp).InclusiveSum(h, incl);
      const int excl = incl - h;
      if (tid < 256 && excl < rest && rest <= incl) {
        s_bin = 255 - tid;
        s_above = excl;
      }
      __syncthreads();
      prefix |= (uint32_t)s_bin << shift;
      rest -= s_above;
      __syncthreads();  // s_bin, s_above and scan_tmp are reused
    }
    const uint32_t thr = prefix;
    const int need_eq = rest;  // >= 1 keys equal to thr are taken

    // -- 3. select: keys above thr, and the lowest indices at thr ----------
    for (int j = tid; j < L; j += kThreads) s_sort[j] = ~0ull;  // padding sorts last
    if (tid == 0) s_n = 0;
    __syncthreads();
    int eq_before = 0;
    for (int base = 0; base < N; base += kThreads) {
      const int i = base + tid;
      const uint32_t k = i < N ? a.keys[i] : 0u;
      const int is_eq = (i < N && k == thr) ? 1 : 0;
      int excl, agg;
      Scan(scan_tmp).ExclusiveSum(is_eq, excl, agg);
      if (i < N && (k > thr || (is_eq && eq_before + excl < need_eq))) {
        const int slot = atomicAdd(&s_n, 1);
        s_sort[slot] = ((unsigned long long)(~k) << 32) | (unsigned long long)(uint32_t)i;
      }
      eq_before += agg;
      __syncthreads();  // scan_tmp is reused
    }

    // -- 4. order: bitonic sort ascending of (~key, index) ------------------
    for (int k2 = 2; k2 <= L; k2 <<= 1) {
      for (int j = k2 >> 1; j > 0; j >>= 1) {
        for (int i = tid; i < L; i += kThreads) {
          const int ixj = i ^ j;
          if (ixj > i) {
            const unsigned long long x = s_sort[i], y = s_sort[ixj];
            const bool up = (i & k2) == 0;
            if ((x > y) == up) {
              s_sort[i] = y;
              s_sort[ixj] = x;
            }
          }
        }
        __syncthreads();
      }
    }

    // -- 5. outputs and the carry update (engine.py:3167-3195) -------------
    if (tid == 0) s_placed = 0;
    __syncthreads();
    for (int k = tid; k < K; k += kThreads) {
      const unsigned long long c = s_sort[k];
      const uint32_t key = ~(uint32_t)(c >> 32);
      const int idx = (int)(c & 0xFFFFFFFFull);
      const float score = key_f32(key);
      const bool v = k < want_eff && score > -INFINITY;
      const size_t o = (size_t)t * K + k;
      a.top_idx[o] = idx;
      a.top_scores[o] = v ? score : 0.f;
      a.valid[o] = v ? 1 : 0;
      if (!v) continue;
      atomicAdd(&s_placed, 1);
      for (int d = 0; d < D; ++d)
        a.used[(size_t)idx * D + d] = __fadd_rn(a.used[(size_t)idx * D + d], a.asks[(size_t)g * D + d]);
      a.tg_counts[(size_t)g * N + idx] += 1;
      a.job_counts[idx] += 1;
      for (int s = 0; s < S; ++s) {
        const size_t row = (size_t)g * S + s;
        if (!a.spread_active[row]) continue;
        const int vid = a.spread_vids[row * N + idx];
        if (vid >= 0 && vid < V) atomicAdd(&a.spread_counts[row * V + vid], 1.f);
      }
    }
    __syncthreads();
    if (tid == 0) {
      a.placed[t] = s_placed;
      a.deficit[g] = want_total - s_placed;
    }
    __syncthreads();
  }
}

}  // namespace

extern "C" int chunk_scan_launch(const ChunkArgs* args, void* stream) {
  if (args->T == 0) return 0;
  if (args->K < 1 || args->K > kMaxK || args->K > args->N) return (int)cudaErrorInvalidValue;
  int L = 1;
  while (L < args->K) L <<= 1;
  chunk_scan_kernel<<<1, kThreads, sizeof(unsigned long long) * (size_t)L, (cudaStream_t)stream>>>(*args);
  return (int)cudaGetLastError();
}

extern "C" const char* chunk_scan_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}

extern "C" int chunk_scan_args_size() { return (int)sizeof(ChunkArgs); }
