// Chunked throughput scan (K5), float arm: one eval's node axis over a
// thread-block cluster.
//
// Replaces the XLA program of nomad_tpu/tpu/engine.py:3033-3210
// (_build_chunk_scan): each step places up to K instances of one task
// group on the top-K scoring distinct feasible nodes, with a per-TG
// deficit carry that rolls a chunk's shortfall into the TG's later steps.
// The JAX program is pure; here the carry (used, tg_counts, job_counts,
// spread_counts) and the deficit are updated IN PLACE in device memory,
// and the wrapper (kernels.py) returns the same tensors.
//
// Shape of the work. The steps depend on each other through the carry, so
// the T steps run in order inside one persistent cluster of CS CTAs (the
// loop replaces lax.scan); run_chunked launches one eval at a time. The
// launch plan (kernels.chunk_plan) picks CS, gives CTA r the contiguous
// node slice [r * per, (r + 1) * per) and lays out its dynamic shared
// memory: the slice's keys, the list of its placed nodes, the histogram
// exchange slots and the deficit replica always; then, where there is
// room, the winners' list and staged copies of the task groups' inputs
// and of the slice of every per-node array (the carried used, job and
// task-group counts are updated there by their owner and written back at
// the end). An array the plan finds no room for stays in its tensor. A
// step:
//   1. score pass: each thread scores a contiguous run of its CTA's slice
//      (fit, distinct_hosts, binpack, anti-affinity, affinity, targeted
//      spread, engine.py:3079-3166) into a 32-bit order-preserving key in
//      shared memory (IEEE total order: -inf below every finite value, -0
//      below +0, the order lax.top_k sorts in), and adds it to the first
//      radix pass's histogram; it also counts the keys above +inf (+NaN)
//      and the valid ones (above -inf, at most +inf);
//   2. the K-th largest key by a cluster-wide radix select, 8 bits a
//      pass from the top: each CTA's histogram of its keys under the
//      prefix, built warp-aggregated (__match_any_sync: one shared atomic
//      per distinct digit of a warp, so tied keys cost one), is sent to
//      every CTA with st.async (distributed shared memory, slot [pass
//      parity][rank]) and counted by that CTA's transaction barrier; every
//      CTA sums the CS histograms, and every warp of it finds the same bin
//      from the sums (no CTA barrier to hand the bin round), and keeps
//      each CTA's count above it (and, in the last pass, at it); two CTA
//      barriers a pass, the local histograms double-buffered. A pass
//      after which the keys at or above its bin fit the winners' list
//      (list_cap entries, at least K: kernels.chunk_list_cap) ends the
//      select: all of them go to the list, and no ties are left to place;
//   3. ties and order: the list's keys (those at or above the last bin,
//      or, after the fourth pass, those above the threshold key; A of
//      them; CTA r's offset is the lower ranks' counts, known from the
//      histograms) go to every CTA as 64-bit composites (~key, index) by
//      st.async on a third barrier, or, past the shared-memory list, to a
//      global scratch row behind a cluster barrier. Each CTA ranks its own
//      by counting the list entries below them (a warp an entry, the
//      lanes striding the list): key descending, index ascending, which
//      is lax.top_k's order; those ranked below K are winners. After the
//      fourth pass the winners at the threshold are the lowest indices
//      among the equal keys: a thread's count over its run, one scan of
//      the warps' counts, and the lower CTAs' counts from the last pass
//      give each its place after the A;
//   4. the carry: validity (engine.py:3169-3173) from the slot; placed is
//      known to every CTA from the first pass's counts (the valid slots
//      are those below want_eff between the +NaN keys and the first
//      -inf); each valid winner's owner updates its used, tg_counts and
//      job_counts without atomics (the nodes are distinct) and adds 1.0f
//      to spread_counts[g,s,v] with atomicAdd (exact in f32 below 2**24,
//      in any order). The deficit is a replica in every CTA, updated
//      alike. A step that added to spread counts ends in a cluster barrier
//      (release/acquire), so the next score pass reads them whole.
// The slots past want_eff still carry the next-best nodes, as in JAX:
// top_idx is compared over all K slots. Every exchange and barrier is
// reached by every thread of every CTA, a CTA with an empty slice too:
// every decision on the way (the passes, the list, the spread barrier) is
// taken from the same merged counts in every CTA.
//
// Float arithmetic: every operation rounds on its own (__f*_rn, never
// contracted into FMA) in the JAX program's order, pow(10, x) is powf
// (the function torch.pow calls on the card), big = finfo(f32).max / 16,
// final = ((binpack + anti) + affinity) + spread_total, spread terms
// summed over s = 0..S-1 in index order. The score is recovered from the
// key (the map is a bijection), so no score row is kept.
//
// What bounds it on an H100: not bytes or operations (a C1M run at N =
// 5,120, ~1,430 steps, moves a few hundred MB of L2-resident rows and does
// ~10^9 operations) but the latency of each step's chain: one to four
// histogram exchanges and the list's exchange across the cluster, the
// CTA barriers between the parts, and the ranking loop over the list
// (A / 32 entries a lane). The design keeps the keys in shared memory
// (no global round trip per pass), spreads the node axis over up to 16
// SMs, and replaces the tie pass's per-tile barriers and the bitonic
// sort's stages by one scan and a count. Section timing
// (kernels.chunk_scan_sections) splits a step's cycles.

#include <cstdint>
#include <cooperative_groups.h>
#include <cuda_runtime.h>

#include "common.cuh"

namespace cg = cooperative_groups;
using namespace nomad;

namespace {

constexpr int kThreads = 512;
constexpr int kWarps = kThreads / 32;
constexpr int kMaxCluster = 16;
// kernels.py SMEM_PER_CTA and STATIC_SMEM_RESERVE
constexpr int kSmemPerCta = 232448;
constexpr int kStaticSmemReserve = 8192;
constexpr int kDynSmemMax = kSmemPerCta - kStaticSmemReserve;
constexpr int kBins = 256;
// one CTA's histogram on the wire: 256 bins, the +NaN and valid counts,
// two spare words (kernels.py CHUNK_HIST_BYTES)
constexpr int kHistWords = 260;
constexpr int kHistVec = kHistWords / 4;
constexpr float kF32Big = 3.40282347e+38f / 16.0f;  // finfo(f32).max / 16
constexpr uint32_t kKeyNegInf = 0x007FFFFFu;        // f32_key(-inf)
constexpr uint32_t kKeyPosInf = 0xFF800000u;        // f32_key(+inf)
constexpr int kSections = 4;

// kernels.CHUNK_REGIONS, in order
enum Region {
  kRKeys, kRChosen, kRHist, kRDeficit,
  kRList, kRAsks, kRDesired, kRDhJob, kRDhTg, kRSpWeights, kRSpActive, kRSumSw,
  kRSpDesired, kRUsed, kRJob, kRTgc, kRTotals, kRReserved, kRFeat, kRSVids, kRAff,
  kRegions
};

}  // namespace

// Mirrors ChunkArgs in kernels.py field for field (ints, the region
// offsets, then pointers). Bools are bytes. reserved is full height (the
// chunk gate's "folded reserved" refuses the rest).
struct ChunkArgs {
  int N, D, G, S, V, T, K, has_aff;
  int CS, per, smem_bytes, list_cap;  // list_cap: the winners' list's room (>= K)
  int soff[kRegions];               // byte offset in shared memory, or -1: the tensor
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
  // the winners' list when the plan has no room for it ([K] composites), or null
  unsigned long long* pairs;
  // section timing (kernels.chunk_scan_sections), or null: clock64 cycles
  long long* sections;              // [CS, kSections]
};

namespace {

__device__ __forceinline__ uint32_t f32_key(float f) {
  const uint32_t b = __float_as_uint(f);
  return (b & 0x80000000u) ? ~b : (b | 0x80000000u);
}

__device__ __forceinline__ float key_f32(uint32_t k) {
  return __uint_as_float((k & 0x80000000u) ? (k & 0x7FFFFFFFu) : ~k);
}

// Where a CTA reads its inputs: the staged slice in shared memory (row
// stride per) or the tensor at the slice's first node (row stride N).
struct View {
  const float* totals;
  const float* reserved;
  const float* asks;
  const uint8_t* feat;
  const float* aff;
  const int32_t* desired;
  const uint8_t* dh_job;
  const uint8_t* dh_tg;
  const int32_t* svids;
  const float* spread_desired;
  const float* spread_weights;
  const uint8_t* spread_active;
  const float* sum_sw;
  float* used;
  int32_t* jobc;
  int32_t* tgc;
  int rs_feat, rs_aff, rs_sv, rs_tgc;
};

// The masked score of local node j (global lo + j) for one ask of task
// group g: engine.py:3079-3166, in its order.
__device__ __forceinline__ float masked_score(const ChunkArgs& a, const View& v, int g, int j,
                                              int i, int n_real) {
  const int D = a.D, S = a.S, V = a.V;
  const float* ask = v.asks + (size_t)g * D;
  bool fits = true;
  float util_c = 0.f, util_m = 0.f;
  for (int d = 0; d < D; ++d) {
    // (used + reserved) + ask, engine.py:3093
    const float u = __fadd_rn(__fadd_rn(v.used[(size_t)j * D + d], v.reserved[(size_t)j * D + d]),
                              ask[d]);
    if (d == 0) util_c = u;
    if (d == 1) util_m = u;
    fits = fits && u <= v.totals[(size_t)j * D + d];
  }
  const int tgc = v.tgc[(size_t)g * v.rs_tgc + j];
  const int jc = v.jobc[j];
  const bool dh = v.dh_job[g] ? (jc == 0) : (v.dh_tg[g] ? !(tgc > 0 && jc > 0) : true);
  const uint8_t fb = v.feat[(size_t)g * v.rs_feat + j];
  const bool feasible = (fb & 1) && fits && dh && i < n_real;
  if (!feasible) return -INFINITY;

  const float node_c = __fsub_rn(v.totals[(size_t)j * D + 0], v.reserved[(size_t)j * D + 0]);
  const float node_m = __fsub_rn(v.totals[(size_t)j * D + 1], v.reserved[(size_t)j * D + 1]);
  const float binpack = binpack_f32(util_c, util_m, node_c, node_m);
  const bool anti_present = tgc > 0;
  const float anti = anti_f32(anti_present, tgc, (float)v.desired[g]);
  const bool aff_p = a.has_aff && ((fb >> 1) & 1);
  const float aff = aff_p ? v.aff[(size_t)g * v.rs_aff + j] : 0.f;

  // targeted spread (engine.py:3122-3151); the chunk step reads no
  // spread_has_targets. spread_counts change during the launch (every
  // CTA's atomics): read through L2
  const float sum_sw = max_keep_nan(v.sum_sw[g], kEps);
  float spread_total = 0.f;
  for (int s = 0; s < S; ++s) {
    const size_t row = (size_t)g * S + s;
    float per = 0.f;
    if (v.spread_active[row]) {
      const int vid = v.svids[row * v.rs_sv + j];
      const bool inr = vid >= 0 && vid < V;
      const float used_count = __fadd_rn(inr ? __ldcg(a.spread_counts + row * V + vid) : 0.f, 1.f);
      const float dd = inr ? v.spread_desired[row * V + vid] : 0.f;
      if (vid == V - 1) {
        per = -1.f;
      } else if (dd > 0.f) {
        const float wf = __fdiv_rn(v.spread_weights[row], sum_sw);
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

// digit into the histogram, one shared atomic per distinct digit of the
// warp; every lane of the warp calls it
__device__ __forceinline__ void hist_add(int* hist, bool active, unsigned digit) {
  const unsigned peers = __match_any_sync(0xFFFFFFFFu, active ? digit : 0xFFFFFFFFu);
  if (active && (int)(threadIdx.x & 31) == __ffs(peers) - 1) atomicAdd(&hist[digit], __popc(peers));
}

// the exclusive prefix of v over the CTA's threads in order; every thread
// calls it; s_warp (kWarps ints) is free again when it returns
__device__ __forceinline__ int block_excl_scan(int v, int* s_warp) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  int incl = v;
  for (int o = 1; o < 32; o <<= 1) {
    const int n = __shfl_up_sync(0xFFFFFFFFu, incl, o);
    if (lane >= o) incl += n;
  }
  if (lane == 31) s_warp[warp] = incl;
  __syncthreads();
  int off = 0;
  for (int w = 0; w < warp; ++w) off += s_warp[w];
  __syncthreads();
  return off + incl - v;
}

template <typename E>
__device__ void copy_elems(E* dst, const E* src, int rows, int len, size_t dstride, size_t sstride) {
  const int total = rows * len;
  for (int k = threadIdx.x; k < total; k += kThreads) {
    const int r = k / len, c = k - r * len;
    dst[r * dstride + c] = src[r * sstride + c];
  }
}

__global__ void __launch_bounds__(kThreads, 1) chunk_scan_kernel(const ChunkArgs a) {
  // barriers: the histogram exchange by pass parity, the winners' list
  __shared__ __align__(8) unsigned long long s_bar[3];
  // this CTA's histogram of a pass, by pass parity
  __shared__ __align__(16) int s_hist[2][kHistWords];
  __shared__ int s_tot[kBins];            // the merged bins of a pass, from the top
  __shared__ int s_warp[kWarps];
  __shared__ int s_above[kMaxCluster];    // each CTA's keys above the threshold
  __shared__ int s_eq[kMaxCluster];       // each CTA's keys at the last pass's bin
  __shared__ int s_cnt[2];                // +NaN keys, valid keys (cluster totals)
  __shared__ int s_nlist, s_nchosen;
  __shared__ long long s_sec[kSections];
  extern __shared__ __align__(16) unsigned char s_raw[];

  cg::cluster_group cluster = cg::this_cluster();
  const int CS = a.CS;
  const int crank = (int)cluster.block_rank();
  const int tid = threadIdx.x;
  const int lane = tid & 31, warp = tid >> 5;
  const int N = a.N, D = a.D, G = a.G, S = a.S, V = a.V, K = a.K, per = a.per;
  const int lo = min(crank * per, N);
  const int hi = min(lo + per, N);
  const int n_here = hi - lo;

  // -- this CTA's regions ----------------------------------------------------
  auto staged = [&](int r) { return a.soff[r] >= 0; };
  auto at = [&](int r) { return s_raw + a.soff[r]; };
  uint32_t* keys = reinterpret_cast<uint32_t*>(at(kRKeys));
  int* chosen = reinterpret_cast<int*>(at(kRChosen));
  int* slots = reinterpret_cast<int*>(at(kRHist));  // [2][CS][kHistWords]
  int* s_def = reinterpret_cast<int*>(at(kRDeficit));
  const bool list_smem = staged(kRList);
  unsigned long long* list =
      list_smem ? reinterpret_cast<unsigned long long*>(at(kRList)) : a.pairs;

  View v;
  auto pick = [&](int r, auto* tensor) -> decltype(tensor) {
    return staged(r) ? reinterpret_cast<decltype(tensor)>(at(r)) : tensor;
  };
  v.asks = pick(kRAsks, a.asks);
  v.desired = pick(kRDesired, a.desired);
  v.dh_job = pick(kRDhJob, a.dh_job);
  v.dh_tg = pick(kRDhTg, a.dh_tg);
  v.spread_weights = pick(kRSpWeights, a.spread_weights);
  v.spread_active = pick(kRSpActive, a.spread_active);
  v.sum_sw = pick(kRSumSw, a.sum_spread_weights);
  v.spread_desired = pick(kRSpDesired, a.spread_desired);
  v.used = pick(kRUsed, a.used + (size_t)lo * D);
  v.jobc = pick(kRJob, a.job_counts + lo);
  v.tgc = pick(kRTgc, a.tg_counts + lo);
  v.totals = pick(kRTotals, a.totals + (size_t)lo * D);
  v.reserved = pick(kRReserved, a.reserved + (size_t)lo * D);
  v.feat = pick(kRFeat, a.feat + lo);
  v.svids = pick(kRSVids, a.spread_vids + lo);
  v.aff = a.has_aff ? pick(kRAff, a.aff_score + lo) : nullptr;
  v.rs_tgc = staged(kRTgc) ? per : N;
  v.rs_feat = staged(kRFeat) ? per : N;
  v.rs_sv = staged(kRSVids) ? per : N;
  v.rs_aff = staged(kRAff) ? per : N;

  // -- stage the task groups' inputs and the slice, once ---------------------
  if (staged(kRAsks)) copy_elems(const_cast<float*>(v.asks), a.asks, 1, G * D, 0, 0);
  if (staged(kRDesired)) copy_elems(const_cast<int32_t*>(v.desired), a.desired, 1, G, 0, 0);
  if (staged(kRDhJob)) copy_elems(const_cast<uint8_t*>(v.dh_job), a.dh_job, 1, G, 0, 0);
  if (staged(kRDhTg)) copy_elems(const_cast<uint8_t*>(v.dh_tg), a.dh_tg, 1, G, 0, 0);
  if (staged(kRSpWeights))
    copy_elems(const_cast<float*>(v.spread_weights), a.spread_weights, 1, G * S, 0, 0);
  if (staged(kRSpActive))
    copy_elems(const_cast<uint8_t*>(v.spread_active), a.spread_active, 1, G * S, 0, 0);
  if (staged(kRSumSw)) copy_elems(const_cast<float*>(v.sum_sw), a.sum_spread_weights, 1, G, 0, 0);
  if (staged(kRSpDesired))
    copy_elems(const_cast<float*>(v.spread_desired), a.spread_desired, 1, G * S * V, 0, 0);
  if (staged(kRUsed)) copy_elems(v.used, a.used + (size_t)lo * D, 1, n_here * D, 0, 0);
  if (staged(kRJob)) copy_elems(v.jobc, a.job_counts + lo, 1, n_here, 0, 0);
  if (staged(kRTgc)) copy_elems(v.tgc, a.tg_counts + lo, G, n_here, per, N);
  if (staged(kRTotals))
    copy_elems(const_cast<float*>(v.totals), a.totals + (size_t)lo * D, 1, n_here * D, 0, 0);
  if (staged(kRReserved))
    copy_elems(const_cast<float*>(v.reserved), a.reserved + (size_t)lo * D, 1, n_here * D, 0, 0);
  if (staged(kRFeat)) copy_elems(const_cast<uint8_t*>(v.feat), a.feat + lo, G, n_here, per, N);
  if (staged(kRSVids))
    copy_elems(const_cast<int32_t*>(v.svids), a.spread_vids + lo, G * S, n_here, per, N);
  if (a.has_aff && staged(kRAff))
    copy_elems(const_cast<float*>(v.aff), a.aff_score + lo, G, n_here, per, N);
  copy_elems(s_def, a.deficit, 1, G, 0, 0);
  for (int k = tid; k < 2 * kHistWords; k += kThreads) s_hist[k / kHistWords][k % kHistWords] = 0;
  if (tid == 0) {
    for (int k = 0; k < 3; ++k) mbar_init(&s_bar[k]);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  // every CTA of the cluster runs, its barriers initialized, before any
  // stores into its shared memory (each CTA arms a barrier's phase just
  // before it sends the exchange that phase counts)
  cluster.sync();

  const int n_real = a.n_real[0];
  // each thread owns a contiguous run of the slice
  const int run = (per + kThreads - 1) / kThreads;
  const int l0 = min(tid * run, n_here);
  const int l1 = min(l0 + run, n_here);
  int q = 0;   // histogram passes so far: the slot and barrier parity
  int lq = 0;  // winners' lists so far: the list barrier's phase parity
  const bool timing = a.sections != nullptr && tid == 0;
  long long t_mark = 0;
  if (timing) {
    for (int k = 0; k < kSections; ++k) s_sec[k] = 0;
    t_mark = clock64();
  }
  auto mark = [&](int k) {
    if (timing) {
      const long long t = clock64();
      s_sec[k] += t - t_mark;
      t_mark = t;
    }
  };

  for (int t = 0; t < a.T; ++t) {
    const int g = __ldg(a.tg_idx + t);
    const int want_total = __ldg(a.want + t) + s_def[g];
    const int want_eff = want_total < K ? want_total : K;
    if (tid < kMaxCluster) s_above[tid] = 0;
    if (tid == 0) s_nlist = s_nchosen = 0;
    __syncthreads();

    // -- 1. score pass, with the first pass's histogram ----------------------
    {
      int n_nan = 0, n_valid = 0;
      for (int jj = 0; jj < run; ++jj) {
        const int j = l0 + jj;
        const bool act = j < l1;
        uint32_t k = 0;
        if (act) {
          k = f32_key(masked_score(a, v, g, j, lo + j, n_real));
          keys[j] = k;
          n_nan += k > kKeyPosInf;
          n_valid += k > kKeyNegInf && k <= kKeyPosInf;
        }
        hist_add(s_hist[q & 1], act, k >> 24);
      }
      n_nan = __reduce_add_sync(0xFFFFFFFFu, n_nan);
      n_valid = __reduce_add_sync(0xFFFFFFFFu, n_valid);
      if (lane == 0) {
        if (n_nan) atomicAdd(&s_hist[q & 1][kBins], n_nan);
        if (n_valid) atomicAdd(&s_hist[q & 1][kBins + 1], n_valid);
      }
    }
    mark(0);

    // -- 2. the K-th largest key: radix select across the cluster -----------
    uint32_t prefix = 0;
    int rest = K;       // how many of the K still lie at or below the prefix
    // the keys at or above a pass's bin fit the list: all are gathered
    // and ranked, and the passes end (no ties to place)
    bool exact = false;
    for (int pass = 0; pass < 4; ++pass, ++q) {
      const int shift = 24 - 8 * pass;
      int* hist = s_hist[q & 1];
      if (pass > 0) {
        const uint32_t hi_mask = 0xFFFFFFFFu << (shift + 8);
        for (int jj = 0; jj < run; ++jj) {
          const int j = l0 + jj;
          const uint32_t k = j < l1 ? keys[j] : 0u;
          hist_add(hist, j < l1 && (k & hi_mask) == prefix, (k >> shift) & 255u);
        }
      }
      __syncthreads();
      // send this CTA's histogram into slot [q parity][crank] of every CTA,
      // arming this CTA's barrier of that parity for the CS histograms
      int* slot_q = slots + (q & 1) * CS * kHistWords;
      if (tid == 0) mbar_arm(&s_bar[q & 1], CS * kHistWords * 4);
      for (int k = tid; k < CS * kHistVec; k += kThreads) {
        const int r = k / kHistVec, c = k - r * kHistVec;
        st_async16(slot_q + crank * kHistWords + c * 4, r, &s_bar[q & 1],
                   reinterpret_cast<const uint4*>(hist)[c]);
      }
      // the other parity's histogram (sent in the pass before, whose
      // sends every thread finished before the barrier above) for the next
      for (int k = tid; k < kHistWords; k += kThreads) s_hist[(q + 1) & 1][k] = 0;
      mbar_wait(&s_bar[q & 1], (q >> 1) & 1);
      // the merged bins from the top: s_tot[j] is bin 255 - j
      if (tid < kBins) {
        int h = 0;
        for (int r = 0; r < CS; ++r) h += slot_q[r * kHistWords + (kBins - 1 - tid)];
        s_tot[tid] = h;
      }
      if (pass == 0 && (tid == kBins || tid == kBins + 1)) {
        int c = 0;
        for (int r = 0; r < CS; ++r) c += slot_q[r * kHistWords + tid];
        s_cnt[tid - kBins] = c;
      }
      __syncthreads();
      // every warp finds the bin: lane l sums s_tot[8l .. 8l + 7]
      int b8[8], sum8 = 0;
      for (int i = 0; i < 8; ++i) {
        b8[i] = s_tot[lane * 8 + i];
        sum8 += b8[i];
      }
      int incl = sum8;
      for (int o = 1; o < 32; o <<= 1) {
        const int n = __shfl_up_sync(0xFFFFFFFFu, incl, o);
        if (lane >= o) incl += n;
      }
      int run_c = incl - sum8, bin = -1, above_bin = 0, in_bin = 0;
      if (run_c < rest && rest <= incl) {
        for (int i = 0; i < 8; ++i) {
          if (bin < 0 && run_c < rest && rest <= run_c + b8[i]) {
            bin = kBins - 1 - (lane * 8 + i);
            above_bin = run_c;
            in_bin = b8[i];
          }
          run_c += b8[i];
        }
      }
      const int src = __ffs(__ballot_sync(0xFFFFFFFFu, bin >= 0)) - 1;
      bin = __shfl_sync(0xFFFFFFFFu, bin, src);
      above_bin = __shfl_sync(0xFFFFFFFFu, above_bin, src);
      in_bin = __shfl_sync(0xFFFFFFFFu, in_bin, src);
      prefix |= (uint32_t)bin << shift;
      rest -= above_bin;
      exact = K - rest + in_bin <= a.list_cap;
      if (warp < CS) {
        int above = 0;
        for (int b = bin + 1 + lane; b < kBins; b += 32) above += slot_q[warp * kHistWords + b];
        above = __reduce_add_sync(0xFFFFFFFFu, above);
        if (lane == 0) {
          const int at_bin = slot_q[warp * kHistWords + bin];
          s_above[warp] += above + (exact ? at_bin : 0);
          s_eq[warp] = at_bin;
        }
      }
      if (exact) {
        ++q;
        break;
      }
    }
    __syncthreads();  // s_above, s_eq and s_cnt, whole
    // the list: keys >= sel_lo, ranked; the taken set: those ranked below
    // K, and in the tied case the lowest `need_eq` indices among the keys
    // equal to thr
    const uint32_t thr = prefix;
    const int need_eq = exact ? 0 : rest;
    const unsigned long long sel_lo =
        exact ? (unsigned long long)prefix : (unsigned long long)prefix + 1ull;
    int A = 0, O = 0, E = 0;
    for (int r = 0; r < CS; ++r) {
      A += s_above[r];
      if (r < crank) {
        O += s_above[r];
        E += s_eq[r];
      }
    }
    const int nan_k = min(s_cnt[0], K);
    const int placed = max(0, min(s_cnt[0] + s_cnt[1], want_eff) - nan_k);
    mark(1);

    // -- 3. the winners above the threshold to every CTA; ties; order --------
    if (list_smem && tid == 0) mbar_arm(&s_bar[2], A * 8);
    int eq_here = 0;
    for (int jj = 0; jj < run; ++jj) {
      const int j = l0 + jj;
      const bool act = j < l1;
      const uint32_t k = act ? keys[j] : 0u;
      const bool win = act && (unsigned long long)k >= sel_lo;
      eq_here += act && !exact && k == thr;
      const unsigned wins = __ballot_sync(0xFFFFFFFFu, win);
      int base = 0;
      if (lane == 0 && wins) base = atomicAdd(&s_nlist, __popc(wins));
      base = __shfl_sync(0xFFFFFFFFu, base, 0);
      if (win) {
        const int at_ = O + base + __popc(wins & ((1u << lane) - 1u));
        const unsigned long long c =
            ((unsigned long long)(~k) << 32) | (unsigned long long)(uint32_t)(lo + j);
        if (list_smem) {
          for (int r = 0; r < CS; ++r) st_async8(list + at_, r, &s_bar[2], c);
        } else {
          list[at_] = c;
        }
      }
    }
    // the equal keys' places: lower CTAs' counts, then the threads' runs
    const int eq_before = E + block_excl_scan(eq_here, s_warp);
    if (list_smem) {
      mbar_wait(&s_bar[2], lq & 1);
    } else {
      cluster_barrier();
    }
    ++lq;

    auto emit = [&](int slot, uint32_t key, int i) {
      const float score = key_f32(key);
      const bool ok = slot < want_eff && score > -INFINITY;
      const size_t o = (size_t)t * K + slot;
      a.top_idx[o] = i;
      a.top_scores[o] = ok ? score : 0.f;
      a.valid[o] = ok ? 1 : 0;
      if (ok) chosen[atomicAdd(&s_nchosen, 1)] = i - lo;
    };
    // this CTA's list entries: a warp each, ranked by the entries below
    // them
    const int A_here = s_above[crank];
    for (int w = warp; w < A_here; w += kWarps) {
      const unsigned long long mine = list_smem ? list[O + w] : __ldcg(list + O + w);
      int below = 0;
      for (int e = lane; e < A; e += 32)
        below += (list_smem ? list[e] : __ldcg(list + e)) < mine;
      below = __reduce_add_sync(0xFFFFFFFFu, below);
      if (lane == 0 && below < K) emit(below, ~(uint32_t)(mine >> 32), (int)(uint32_t)mine);
    }
    // the winners at the threshold: the lowest indices first
    if (need_eq > eq_before) {
      int e = eq_before;
      for (int j = l0; j < l1 && e < need_eq; ++j) {
        if (keys[j] == thr) emit(A + e++, thr, lo + j);
      }
    }
    __syncthreads();
    mark(2);

    // -- 4. the carry: each placed node's owner ------------------------------
    const int n_chosen = s_nchosen;
    const float* ask = v.asks + (size_t)g * D;
    bool spread_any = false;
    for (int s = 0; s < S; ++s) spread_any = spread_any || v.spread_active[(size_t)g * S + s];
    for (int c = tid; c < n_chosen; c += kThreads) {
      const int j = chosen[c];
      for (int d = 0; d < D; ++d) v.used[(size_t)j * D + d] = __fadd_rn(v.used[(size_t)j * D + d], ask[d]);
      v.tgc[(size_t)g * v.rs_tgc + j] += 1;
      v.jobc[j] += 1;
      for (int s = 0; s < S; ++s) {
        const size_t row = (size_t)g * S + s;
        if (!v.spread_active[row]) continue;
        const int vid = v.svids[row * v.rs_sv + j];
        if (vid >= 0 && vid < V) atomicAdd(&a.spread_counts[row * V + vid], 1.f);
      }
    }
    if (tid == 0) {
      s_def[g] = want_total - placed;
      if (crank == 0) a.placed[t] = placed;
    }
    if (placed > 0 && spread_any) {
      cluster_barrier();  // the spread counts, whole, before the next score pass
    } else {
      __syncthreads();
    }
    mark(3);
  }

  // -- write back the carried slices and the deficit -----------------------
  if (staged(kRUsed)) copy_elems(a.used + (size_t)lo * D, v.used, 1, n_here * D, 0, 0);
  if (staged(kRJob)) copy_elems(a.job_counts + lo, v.jobc, 1, n_here, 0, 0);
  if (staged(kRTgc)) copy_elems(a.tg_counts + lo, v.tgc, G, n_here, N, per);
  if (crank == 0) copy_elems(a.deficit, s_def, 1, G, 0, 0);
  if (timing)
    for (int k = 0; k < kSections; ++k) a.sections[(size_t)crank * kSections + k] = s_sec[k];
  // no CTA leaves while another may still store into it
  cluster.sync();
}

// Opt in to the plan's dynamic shared memory and to clusters of 16; the
// static shared memory must stay inside the plan's reserve.
cudaError_t configure() {
  cudaFuncAttributes fa;
  cudaError_t e = cudaFuncGetAttributes(&fa, chunk_scan_kernel);
  if (e != cudaSuccess) return e;
  if (fa.sharedSizeBytes > (size_t)kStaticSmemReserve) return cudaErrorInvalidConfiguration;
  e = cudaFuncSetAttribute(chunk_scan_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, kDynSmemMax);
  if (e != cudaSuccess) return e;
  return cudaFuncSetAttribute(chunk_scan_kernel, cudaFuncAttributeNonPortableClusterSizeAllowed, 1);
}

}  // namespace

extern "C" int chunk_scan_launch(const ChunkArgs* args, void* stream) {
  if (args->T == 0) return 0;
  const int cs = args->CS;
  if (args->K < 1 || args->K > args->N || cs < 1 || cs > kMaxCluster || (cs & (cs - 1)) ||
      (long long)args->per * cs < args->N || args->smem_bytes < 0 || args->smem_bytes > kDynSmemMax ||
      args->soff[kRKeys] < 0 || args->soff[kRChosen] < 0 || args->soff[kRHist] < 0 ||
      args->soff[kRDeficit] < 0 || (args->soff[kRList] < 0 && args->pairs == nullptr) ||
      args->list_cap < args->K)
    return (int)cudaErrorInvalidValue;
  cudaError_t e = configure();
  if (e != cudaSuccess) return (int)e;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(cs);
  cfg.blockDim = dim3(kThreads);
  cfg.dynamicSmemBytes = args->smem_bytes;
  cfg.stream = (cudaStream_t)stream;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = cs;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  e = cudaLaunchKernelEx(&cfg, chunk_scan_kernel, *args);
  if (e != cudaSuccess) return (int)e;
  return (int)cudaGetLastError();
}

// cudaOccupancyMaxActiveClusters of the kernel at this cluster size and
// dynamic shared memory: 0 where the card cannot co-schedule it
extern "C" int chunk_scan_max_clusters(int cs, int smem_bytes) {
  if (configure() != cudaSuccess) return -1;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(cs);
  cfg.blockDim = dim3(kThreads);
  cfg.dynamicSmemBytes = smem_bytes;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = cs;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  int n = 0;
  if (cudaOccupancyMaxActiveClusters(&n, chunk_scan_kernel, &cfg) != cudaSuccess) {
    cudaGetLastError();  // a refused size reads as no cluster, not a sticky error
    return 0;
  }
  return n;
}

extern "C" const char* chunk_scan_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}

extern "C" int chunk_scan_args_size() { return (int)sizeof(ChunkArgs); }
