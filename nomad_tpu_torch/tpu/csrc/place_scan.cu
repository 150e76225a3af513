// Placement scan, both arms: one persistent thread block per eval.
//
// Replaces the XLA programs of nomad_tpu/tpu/engine.py:
//   _make_step          (K1, :213)  one placement over all N nodes
//   _build_place_scan   (K2, :869)  lax.scan of the step over P placements
//   _build_batched_scan (K3, :1000) vmap of the scan over B evals
// in both arms of the step:
//   int   (place_scan_launch, T = int32_t): the exact-integer spec, int64
//         score60 selection (engine.py:471-574), and the preemption
//         branch (has_pre, engine.py:383-409 and :761-832) with the
//         greedy sweep (K6), the second pass (K7) and isqrt/coord_q (K8)
//         of nomad_tpu/tpu/preempt.py:171-271 as device functions
//         (common.cuh);
//   float (place_scan_f32_launch, T = float): f32 scores from pow(10, free)
//         binpack, anti-affinity, the reschedule penalty and the spread
//         boosts (engine.py:575-639). The reference never builds a
//         candidate axis in this arm; the instantiation has no branch.
// The bit-packed lanes of nomad_tpu/tpu/intscore.py (K9) are not needed
// here: counts and flags stay unpacked (registers, a per-eval scratch
// row), and the results are the same bits.
//
// Shape of the work. Placements of one eval depend on each other through
// the carry (used capacity, counts, the ring offset), so the P steps run
// in order inside one block (blockIdx.x = eval of the batch); evals are
// independent, so the grid runs B of them at once. Within a step each
// thread owns the nodes tid, tid + T, tid + 2T, ...; a step is
//   1. the previous alloc's eviction (one thread), then per-spread
//      min/max/any over the value vocabulary (block reductions);
//   2. pass 1: feasibility and the score of every node, the count of
//      feasible and low-score nodes before the ring offset;
//   3. pass 2: the ring-ordered LimitIterator emulation as a block-wide
//      exclusive scan tile by tile in natural node order, and the
//      (max score, min rank, first index) selection as a block reduction;
//   4. the carry update for the chosen node (one thread).
// The carry is updated in place in device memory.
//
// Preemption (has_pre). The JAX step runs the greedy sweep on every node
// of every step. Here the thread that owns node i runs it over its own C
// <= 16 slots (an alive bit mask, needed and avail in registers) only
// where it can change the result: a real node, feasible by features,
// distinct_hosts, the forced node and distinct_property, that does not
// fit outright, and whose alive eligible slots together could meet the
// ask. Everywhere else cap_ok = fits | met is decided without it, so the
// outputs are the JAX step's. After selection the
// committing thread recomputes the greedy on the chosen row (it is
// deterministic, so the same round order comes out; no [N, C] scratch),
// runs the second pass and commits: the freed capacity credits used
// after the score terms, the Q27 e_base product over the kept slots in
// slot order, and the pre_alive / pre_remaining / pre_counts carries.
// The per-group preemption counts (<= 64) are read from shared memory,
// loaded once per step.
//
// What bounds it on an H100: not bytes or operations (one eval at
// N = 5,120 moves well under a megabyte and does ~10^8 operations per
// scan) but the P sequential steps, each a chain of block-wide barriers
// and reductions on ONE SM. A batch of B evals runs on B SMs at once;
// the other SMs idle. Splitting the node axis over a thread-block
// cluster is later work.
//
// Hold points carried over from the JAX program. Int arm: floor division
// of possibly negative int64 (floordiv below; C++ '/' truncates),
// arithmetic '>>' of negative int64, neg_inf = INT64_MIN / 4. Float arm:
// every operation rounds on its own, as PyTorch's elementwise ops do
// (the __f*_rn intrinsics, which nvcc never contracts into FMA), in the
// JAX program's order; pow(10, x) is powf, the function torch.pow calls
// on the card; spread_total sums s = 0..S-1 in index order; the max is
// taken by explicit comparisons against the same -inf the JAX program
// gives non-candidates. Both: the first index among tied winners.

#include <cstdint>
#include <cuda_runtime.h>
#include <cub/block/block_reduce.cuh>
#include <cub/block/block_scan.cuh>

#include "common.cuh"

using namespace nomad;

namespace {

constexpr int kThreads = 512;
constexpr int kMaxSkip = 3;
constexpr long long kBigFp = 1LL << 44;
constexpr long long kLarge = 1LL << 40;
constexpr long long kNegInf = -(1LL << 61);  // jnp.iinfo(int64).min // 4
constexpr int kInt32Max = 2147483647;
constexpr float kF32Big = 3.40282347e+38f / 16.0f;  // finfo(f32).max / 16

}  // namespace

// Mirrors ScanArgs in kernels.py field for field (ints first, then
// pointers). Every array carries the leading batch axis B; bool arrays
// are bytes. Arrays marked T hold int32 in the int arm and float32 in
// the float arm; S holds int64 and float32 respectively.
struct ScanArgs {
  int B, N, D, G, S, V, K, DP, V2, P;
  int has_reserved, has_aff, has_evict, has_forced;
  int has_pre, C, GP;  // candidate slots per node (<= 16), count groups (<= 64)
  // static
  const void* totals;             // T [B,N,D]
  const void* reserved;           // T [B,N,D] when has_reserved
  const void* asks;               // T [B,G,D]
  const uint8_t* feat;            // [B,G,N] bit0 feasible, bit1 affinity
  const void* aff_score;          // T [B,G,N] when has_aff
  const int32_t* desired;         // [B,G]
  const uint8_t* dh_job;          // [B,G]
  const uint8_t* dh_tg;           // [B,G]
  const int32_t* spread_vids;     // [B,G,S,N]
  const void* spread_desired;     // T [B,G,S,V]
  const void* spread_weights;     // T [B,G,S]
  const uint8_t* spread_has_targets;  // [B,G,S]
  const uint8_t* spread_active;   // [B,G,S]
  const int32_t* n_real;          // [B]
  const int32_t* e_ask;           // [B,G,N,2] int arm
  const int32_t* dp_vids;         // [B,DP,N]
  const int32_t* dp_limit;        // [B,DP]
  const uint8_t* dp_applies;      // [B,G,DP]
  // carry (updated in place)
  void* used;                     // T [B,N,D]
  int32_t* tg_counts;             // [B,G,N]
  int32_t* job_counts;            // [B,N]
  void* spread_counts;            // T [B,G,S,V]
  uint8_t* spread_entry;          // [B,G,S,V]
  int32_t* offset;                // [B]
  uint8_t* failed;                // [B,G]
  int32_t* e_base;                // [B,N,2] int arm
  int32_t* dp_counts;             // [B,DP,V2]
  // per placement
  const int32_t* tg_idx;          // [B,P]
  const int32_t* penalty_idx;     // [B,P,K]
  const int32_t* evict_node;      // [B,P]
  const void* evict_res;          // T [B,P,D] when has_evict
  const int32_t* evict_tg;        // [B,P]
  const int32_t* limit_p;         // [B,P]
  const void* sum_sw_p;           // T [B,P]
  const int32_t* ev_factor;       // [B,P,2] when has_evict (int arm)
  const int32_t* rev_factor;      // [B,P,2] when has_evict (int arm)
  const int32_t* forced_node;     // [B,P,1] when has_forced
  // outputs
  int32_t* chosen;                // [B,P]
  void* scores;                   // S [B,P]
  int32_t* pulls;                 // [B,P]
  uint8_t* skipped;               // [B,P]
  // scratch
  void* scr_final;                // S [B,N]
  uint8_t* scr_flags;             // [B,N] bit0 feasible&valid, bit1 low, bit2 fits
  // preemption (has_pre, int arm): static, carry, output
  const int32_t* pre_res;         // [B,N,C,4]
  const int32_t* pre_prio;        // [B,N,C]
  const uint8_t* pre_elig;        // [B,N,C]
  const int32_t* pre_mp;          // [B,N,C]
  const int32_t* pre_gid;         // [B,N,C]
  const int32_t* pre_evf;         // [B,N,C,2]
  uint8_t* pre_alive;             // [B,N,C]
  long long* pre_remaining;       // [B,N,3]
  int32_t* pre_counts;            // [B,GP]
  int32_t* evict_out;             // [B,P,C] rank of each evicted slot; the
                                  // wrapper fills -1, the kernel writes ranks
};

namespace {

// The penalty of each slot of row i from the step's preemption counts,
// and the row's candidate view for the greedy (int arm).
__device__ __forceinline__ PreRow pre_row(const ScanArgs& a, size_t bNC, size_t bN, int i,
                                          const int* s_pre_counts, long long* pen) {
  const int C = a.C;
  const size_t base = bNC + (size_t)i * C;
  PreRow row;
  row.C = C;
  row.res = a.pre_res + base * 4;
  row.prio = a.pre_prio + base;
  row.pen = pen;
  row.alive = 0;
  for (int c = 0; c < C; ++c) {
    const int gid = a.pre_gid[base + c];
    const int mp = a.pre_mp[base + c];
    const int num = (gid >= 0 && gid < a.GP) ? s_pre_counts[gid] : 0;
    pen[c] = (mp > 0 && num >= mp) ? (long long)((num + 1) - mp) * kPenaltyUnit * kCqOne : 0;
    if (a.pre_alive[base + c] && a.pre_elig[base + c]) row.alive |= 1u << c;
  }
  const long long* rem = a.pre_remaining + (bN + i) * 3;
  row.remaining[0] = rem[0];
  row.remaining[1] = rem[1];
  row.remaining[2] = rem[2];
  return row;
}

// Per arm: the score type, the spread count type, and the score given to
// non-candidates (engine.py:573 and :638).
template <typename T> struct Arm;
template <> struct Arm<int32_t> {
  using Score = long long;
  using Count = long long;
  static constexpr bool kFloat = false;
  static __device__ __forceinline__ Score neg_inf() { return kNegInf; }
};
template <> struct Arm<float> {
  using Score = float;
  using Count = float;
  static constexpr bool kFloat = true;
  static __device__ __forceinline__ Score neg_inf() { return -INFINITY; }
};

template <typename Score>
struct Best {
  Score score;
  int rank;
  int idx;
};

template <typename Score>
struct BestOp {
  __device__ __forceinline__ Best<Score> operator()(const Best<Score>& a,
                                                    const Best<Score>& b) const {
    if (a.score != b.score) return a.score > b.score ? a : b;
    if (a.rank != b.rank) return a.rank < b.rank ? a : b;
    return a.idx <= b.idx ? a : b;
  }
};

struct Counts {
  int low_before, feas_before, low_total, feas_total, pulls;
};

struct CountsSum {
  __device__ __forceinline__ Counts operator()(const Counts& a, const Counts& b) const {
    return {a.low_before + b.low_before, a.feas_before + b.feas_before,
            a.low_total + b.low_total, a.feas_total + b.feas_total,
            a.pulls + b.pulls};
  }
};

template <typename C>
struct Entries {
  C min_c, max_c;
  int any;
};

template <typename C>
struct EntriesOp {
  __device__ __forceinline__ Entries<C> operator()(const Entries<C>& a,
                                                   const Entries<C>& b) const {
    return {a.min_c < b.min_c ? a.min_c : b.min_c,
            a.max_c > b.max_c ? a.max_c : b.max_c, a.any | b.any};
  }
};

template <typename C>
struct SpreadStat {
  C min_c, max_c;
  long long r_min;  // int arm: the Q45 reciprocal of min_c
  int has_entries;
};

template <typename T>
__global__ void __launch_bounds__(kThreads) place_scan_kernel(const ScanArgs a) {
  using Score = typename Arm<T>::Score;
  using Count = typename Arm<T>::Count;
  constexpr bool kFloat = Arm<T>::kFloat;
  using ReduceBest = cub::BlockReduce<Best<Score>, kThreads>;
  using ReduceCounts = cub::BlockReduce<Counts, kThreads>;
  using ReduceEntries = cub::BlockReduce<Entries<Count>, kThreads>;
  using ScanPair = cub::BlockScan<long long, kThreads>;
  __shared__ union {
    typename ReduceBest::TempStorage best;
    typename ReduceCounts::TempStorage counts;
    typename ReduceEntries::TempStorage entries;
    typename ScanPair::TempStorage scan;
  } tmp;
  __shared__ Counts s_counts;
  __shared__ int s_pre_counts[kGpMax];
  extern __shared__ __align__(8) unsigned char s_raw[];
  SpreadStat<Count>* s_stat = reinterpret_cast<SpreadStat<Count>*>(s_raw);  // [S]

  const int b = blockIdx.x;
  const int tid = threadIdx.x;
  const int N = a.N, D = a.D, G = a.G, S = a.S, V = a.V, K = a.K;
  const int DP = a.DP, V2 = a.V2, P = a.P;
  const size_t bN = (size_t)b * N;

  const T* totals = static_cast<const T*>(a.totals) + bN * D;
  const T* reserved = a.has_reserved ? static_cast<const T*>(a.reserved) + bN * D : nullptr;
  const T* asks = static_cast<const T*>(a.asks) + (size_t)b * G * D;
  const uint8_t* feat = a.feat + (size_t)b * G * N;
  const T* aff_score = a.has_aff ? static_cast<const T*>(a.aff_score) + (size_t)b * G * N : nullptr;
  const int32_t* desired = a.desired + (size_t)b * G;
  const uint8_t* dh_job = a.dh_job + (size_t)b * G;
  const uint8_t* dh_tg = a.dh_tg + (size_t)b * G;
  const int32_t* spread_vids = a.spread_vids + (size_t)b * G * S * N;
  const T* spread_desired = static_cast<const T*>(a.spread_desired) + (size_t)b * G * S * V;
  const T* spread_weights = static_cast<const T*>(a.spread_weights) + (size_t)b * G * S;
  const uint8_t* spread_has_targets = a.spread_has_targets + (size_t)b * G * S;
  const uint8_t* spread_active = a.spread_active + (size_t)b * G * S;
  const int32_t* e_ask = kFloat ? nullptr : a.e_ask + (size_t)b * G * N * 2;
  const int32_t* dp_vids = a.dp_vids + (size_t)b * DP * N;
  const int32_t* dp_limit = a.dp_limit + (size_t)b * DP;
  const uint8_t* dp_applies = a.dp_applies + (size_t)b * G * DP;
  T* used = static_cast<T*>(a.used) + bN * D;
  int32_t* tg_counts = a.tg_counts + (size_t)b * G * N;
  int32_t* job_counts = a.job_counts + bN;
  T* spread_counts = static_cast<T*>(a.spread_counts) + (size_t)b * G * S * V;
  uint8_t* spread_entry = a.spread_entry + (size_t)b * G * S * V;
  int32_t* offset_p = a.offset + b;
  uint8_t* failed = a.failed + (size_t)b * G;
  int32_t* e_base = kFloat ? nullptr : a.e_base + bN * 2;
  int32_t* dp_counts = a.dp_counts + (size_t)b * DP * V2;
  const size_t bP = (size_t)b * P;
  const int32_t* tg_idx = a.tg_idx + bP;
  const int32_t* penalty_idx = a.penalty_idx + bP * K;
  const int32_t* evict_node = a.evict_node + bP;
  const T* evict_res = a.has_evict ? static_cast<const T*>(a.evict_res) + bP * D : nullptr;
  const int32_t* evict_tg = a.evict_tg + bP;
  const int32_t* limit_p = a.limit_p + bP;
  const T* sum_sw_p = static_cast<const T*>(a.sum_sw_p) + bP;
  const int32_t* ev_factor = (a.has_evict && !kFloat) ? a.ev_factor + bP * 2 : nullptr;
  const int32_t* rev_factor = (a.has_evict && !kFloat) ? a.rev_factor + bP * 2 : nullptr;
  const int32_t* forced_node = a.has_forced ? a.forced_node + bP : nullptr;
  Score* scores = static_cast<Score*>(a.scores) + bP;
  Score* scr_final = static_cast<Score*>(a.scr_final) + bN;
  uint8_t* scr_flags = a.scr_flags + bN;

  const int n_real = a.n_real[b];
  const int nr = n_real > 1 ? n_real : 1;
  const int invalid_bucket = V - 1;
  const bool has_pre = !kFloat && a.has_pre;
  const size_t bNC = bN * (size_t)a.C;

  for (int p = 0; p < P; ++p) {
    // All threads read the step's scalars; the previous step's carry
    // writes were fenced by the barrier that ended it.
    const int g = tg_idx[p];
    const bool skip = failed[g] != 0;
    if (skip) {
      // a step of a failed task group (or a batch's padding) changes
      // nothing of the carry: write its outputs and move on
      if (tid == 0) {
        a.chosen[bP + p] = -1;
        scores[p] = (Score)0;
        a.pulls[bP + p] = 0;
        a.skipped[bP + p] = 1;
      }
      continue;
    }
    const int offset = *offset_p;
    const int limit = limit_p[p];

    // -- eviction of the previous alloc (engine.py:291-332) ----------------
    const int ev_node_raw = evict_node[p];
    const int ev_tg_raw = evict_tg[p];
    const bool do_evict = a.has_evict && ev_node_raw >= 0 && !skip;
    const int ev_node = ev_node_raw > 0 ? ev_node_raw : 0;
    const int ev_tg = ev_tg_raw > 0 ? ev_tg_raw : 0;
    const bool dec_tg = do_evict && ev_tg_raw >= 0;
    if (tid == 0 && do_evict) {
      for (int d = 0; d < D; ++d) used[ev_node * D + d] = sub_t(used[ev_node * D + d], evict_res[p * D + d]);
      job_counts[ev_node] -= 1;
      if (dec_tg) {
        tg_counts[ev_tg * N + ev_node] -= 1;
        for (int s = 0; s < S; ++s) {
          if (!spread_active[ev_tg * S + s]) continue;
          const int vid = spread_vids[((size_t)ev_tg * S + s) * N + ev_node];
          if (vid >= 0 && vid < V) {
            T& c = spread_counts[((size_t)ev_tg * S + s) * V + vid];
            c = sub_t(c, (T)1);
          }
        }
      }
      if constexpr (!kFloat) {
        for (int d = 0; d < 2; ++d)
          e_base[ev_node * 2 + d] =
              (int32_t)(((long long)e_base[ev_node * 2 + d] * ev_factor[p * 2 + d]) >> kE27Bits);
      }
    }
    if (has_pre)
      for (int k = tid; k < a.GP; k += kThreads) s_pre_counts[k] = a.pre_counts[(size_t)b * a.GP + k];
    __syncthreads();

    // -- per-spread entry statistics (engine.py:469, :522-532, :601-605) ----
    for (int s = 0; s < S; ++s) {
      const size_t row = ((size_t)g * S + s) * V;
      Entries<Count> e;
      if constexpr (kFloat) {
        e = {INFINITY, -INFINITY, 0};
      } else {
        e = {kLarge, -kLarge, 0};
      }
      for (int v = tid; v < invalid_bucket; v += kThreads) {
        if (spread_entry[row + v]) {
          const Count c = spread_counts[row + v] > 0 ? (Count)spread_counts[row + v] : (Count)0;
          e = EntriesOp<Count>()(e, Entries<Count>{c, c, 1});
        }
      }
      const Entries<Count> r = ReduceEntries(tmp.entries).Reduce(e, EntriesOp<Count>());
      if (tid == 0) {
        SpreadStat<Count> st;
        st.has_entries = r.any;
        st.min_c = r.any ? r.min_c : (Count)0;
        st.max_c = r.any ? r.max_c : (Count)0;
        st.r_min = 0;
        if constexpr (!kFloat) st.r_min = (1LL << kRecipBits) / (st.min_c > 1 ? st.min_c : 1);
        s_stat[s] = st;
      }
      __syncthreads();
    }

    // -- pass 1: feasibility and score of every node -----------------------
    const uint8_t* feat_g = feat + (size_t)g * N;
    const int32_t* tgc_g = tg_counts + (size_t)g * N;
    const int32_t* e_ask_g = kFloat ? nullptr : e_ask + (size_t)g * N * 2;
    const bool dh_job_g = dh_job[g] != 0;
    const bool dh_tg_g = dh_tg[g] != 0;
    const long long desired_g = desired[g] > 1 ? desired[g] : 1;
    const long long q_d = (1LL << kRecipBits) / desired_g;
    const float desired_f = (float)desired[g];
    const int fnode = a.has_forced ? forced_node[p] : -1;
    long long ask3[3] = {0, 0, 0};
    if (has_pre)
      for (int d = 0; d < 3; ++d) ask3[d] = (long long)asks[g * D + d];
    Counts cnt = {0, 0, 0, 0, 0};
    for (int i = tid; i < N; i += kThreads) {
      bool fits = true;
      T util_cm[2] = {(T)0, (T)0};
      for (int d = 0; d < D; ++d) {
        T util = used[i * D + d];
        if constexpr (kFloat) {
          // (used + reserved) + ask, engine.py:362
          if (reserved) util = __fadd_rn(util, reserved[i * D + d]);
          util = __fadd_rn(util, asks[g * D + d]);
        } else {
          util += asks[g * D + d];
          if (reserved) util += reserved[i * D + d];
        }
        if (d < 2) util_cm[d] = util;
        fits = fits && util <= totals[i * D + d];
      }
      const int tgc = tgc_g[i];
      const int jc = job_counts[i];
      const bool dh = dh_job_g ? (jc == 0) : (dh_tg_g ? !(tgc > 0 && jc > 0) : true);
      const uint8_t fbits = feat_g[i];
      // every mask but capacity first (the AND is order-free)
      bool feasible = (fbits & 1) && dh;
      if (a.has_forced) feasible = feasible && (fnode < 0 || i == fnode);
      for (int d = 0; d < DP; ++d) {
        const int vid = dp_vids[(size_t)d * N + i];
        int c = 0;
        if (vid >= 0 && vid < V2) c = dp_counts[d * V2 + vid] > 0 ? dp_counts[d * V2 + vid] : 0;
        const bool applies = dp_applies[g * DP + d] != 0;
        const bool missing = vid == V2 - 1;
        feasible = feasible && (!applies || (!missing && c < dp_limit[d]));
      }
      bool cap_ok = fits;
      if constexpr (!kFloat) {
        // preemption rescue, cap_ok = fits | met, only where it can decide
        if (has_pre && feasible && !fits && i < n_real) {
          long long pen[kCMax];
          const PreRow row = pre_row(a, bNC, bN, i, s_pre_counts, pen);
          cap_ok = can_meet(ask3, row) && greedy_row(ask3, row, nullptr, nullptr);
        }
      }
      feasible = feasible && cap_ok;
      bool pmask = false;
      for (int k = 0; k < K; ++k) pmask = pmask || penalty_idx[p * K + k] == i;
      const bool anti_present = tgc > 0;
      const bool aff_p = aff_score != nullptr && ((fbits >> 1) & 1);

      Score final_score;
      if constexpr (kFloat) {
        // engine.py:576-581
        const float node_c = reserved ? __fsub_rn(totals[i * D + 0], reserved[i * D + 0]) : totals[i * D + 0];
        const float node_m = reserved ? __fsub_rn(totals[i * D + 1], reserved[i * D + 1]) : totals[i * D + 1];
        const float binpack = binpack_f32(util_cm[0], util_cm[1], node_c, node_m);
        const float anti = anti_f32(anti_present, tgc, desired_f);
        const float resched = pmask ? -1.f : 0.f;
        const float aff = aff_p ? aff_score[(size_t)g * N + i] : 0.f;

        float spread_total = 0.f;
        for (int s = 0; s < S; ++s) {
          float per = 0.f;
          if (spread_active[g * S + s]) {
            const size_t row = ((size_t)g * S + s);
            const int vid = spread_vids[row * N + i];
            const bool inr = vid >= 0 && vid < V;
            float cur = 0.f, dd = 0.f;
            if (inr) {
              cur = spread_counts[row * V + vid] > 0.f ? spread_counts[row * V + vid] : 0.f;
              dd = spread_desired[row * V + vid];
            }
            if (vid == invalid_bucket) {
              per = -1.f;
            } else if (spread_has_targets[g * S + s]) {
              if (dd > 0.f) {
                const float wf = __fdiv_rn(spread_weights[g * S + s], max_keep_nan(sum_sw_p[p], kEps));
                per = __fmul_rn(__fdiv_rn(__fsub_rn(dd, __fadd_rn(cur, 1.f)), dd), wf);
              } else {
                per = dd == 0.f ? -kF32Big : -1.f;
              }
            } else {
              const SpreadStat<Count> st = s_stat[s];
              if (!st.has_entries) {
                per = 0.f;
              } else if (cur != st.min_c) {
                per = st.min_c == 0.f ? -1.f
                                      : __fdiv_rn(__fsub_rn(st.min_c, cur), max_keep_nan(st.min_c, kEps));
              } else if (st.min_c == st.max_c) {
                per = -1.f;
              } else if (st.min_c == 0.f) {
                per = 1.f;
              } else {
                per = __fdiv_rn(__fsub_rn(st.max_c, st.min_c), max_keep_nan(st.min_c, kEps));
              }
            }
          }
          spread_total = __fadd_rn(spread_total, per);
        }
        const int num_terms = 1 + (int)anti_present + (int)pmask + (int)aff_p + (int)(spread_total != 0.f);
        float sum = __fadd_rn(binpack, anti);
        sum = __fadd_rn(sum, resched);
        sum = __fadd_rn(sum, aff);
        sum = __fadd_rn(sum, spread_total);
        final_score = __fdiv_rn(sum, (float)num_terms);
      } else {
        const long long sw64 = sum_sw_p[p] > 1 ? (long long)sum_sw_p[p] : 1LL;
        const long long binpack = binpack_q30(e_sel(e_base, e_ask_g, i, 0), e_sel(e_base, e_ask_g, i, 1));
        const long long anti = anti_q30(anti_present, tgc, q_d);
        const long long resched = pmask ? -kTermOne : 0;
        const long long aff = aff_p ? (long long)aff_score[(size_t)g * N + i] : 0;

        long long spread_total = 0;
        for (int s = 0; s < S; ++s) {
          if (!spread_active[g * S + s]) continue;
          const size_t row = ((size_t)g * S + s);
          const int vid = spread_vids[row * N + i];
          const bool inr = vid >= 0 && vid < V;
          long long cur = 0, dd = 0;
          if (inr) {
            cur = spread_counts[row * V + vid] > 0 ? spread_counts[row * V + vid] : 0;
            dd = spread_desired[row * V + vid];
          }
          long long per;
          if (vid == invalid_bucket) {
            per = -kTermOne;
          } else if (spread_has_targets[g * S + s]) {
            if (dd > 0) {
              const long long t_num = (dd - 100 * (cur + 1)) * (long long)spread_weights[g * S + s] * kTermOne;
              per = floordiv(t_num, dd * sw64);
            } else {
              per = dd == 0 ? -kBigFp : -kTermOne;
            }
          } else {
            const SpreadStat<Count> st = s_stat[s];
            if (!st.has_entries) {
              per = 0;
            } else if (cur != st.min_c) {
              per = st.min_c == 0 ? -kTermOne : (((st.min_c - cur) * st.r_min) >> kRsh);
            } else if (st.min_c == st.max_c) {
              per = -kTermOne;
            } else if (st.min_c == 0) {
              per = kTermOne;
            } else {
              per = ((st.max_c - st.min_c) * st.r_min) >> kRsh;
            }
          }
          spread_total += per;
        }
        const int num_terms = 1 + (int)anti_present + (int)pmask + (int)aff_p + (int)(spread_total != 0);
        const long long factor = 60 / num_terms;
        final_score = (binpack + anti + resched + aff + spread_total) * factor;
      }

      const bool feas_v = feasible && i < n_real;
      const bool low = feas_v && final_score <= (Score)0;
      scr_final[i] = final_score;
      scr_flags[i] = (uint8_t)((int)feas_v | ((int)low << 1) | ((int)fits << 2));
      cnt.low_total += low;
      cnt.feas_total += feas_v;
      if (i < offset) {
        cnt.low_before += low;
        cnt.feas_before += feas_v;
      }
    }
    {
      const Counts r = ReduceCounts(tmp.counts).Reduce(cnt, CountsSum());
      if (tid == 0) s_counts = r;
      __syncthreads();
    }
    const Counts tot = s_counts;
    const int ret_total = tot.feas_total - (tot.low_total < kMaxSkip ? tot.low_total : kMaxSkip);
    const int backlog_n = limit - ret_total > 0 ? limit - ret_total : 0;

    // -- pass 2: ring cumsums, limit window, selection (engine.py:660-723) --
    // The two counts ride one 64-bit scan value: low in the low word,
    // feasible in the high word (each total < 2**31, so no carry).
    Best<Score> best = {Arm<T>::neg_inf(), kInt32Max, kInt32Max};
    int pulls_local = 0;
    long long nat_before = 0;  // natural-order counts of earlier tiles
    for (int base = 0; base < N; base += kThreads) {
      const int i = base + tid;
      int low = 0, fv = 0;
      Score fin = 0;
      if (i < N) {
        const uint8_t f = scr_flags[i];
        fv = f & 1;
        low = (f >> 1) & 1;
        fin = scr_final[i];
      }
      const long long x = (long long)low | ((long long)fv << 32);
      long long excl, agg;
      ScanPair(tmp.scan).ExclusiveSum(x, excl, agg);
      __syncthreads();
      if (i < N) {
        const long long nat = nat_before + excl + x;  // inclusive
        const int nat_low = (int)(nat & 0xffffffffLL);
        const int nat_feas = (int)(nat >> 32);
        const int low_cum = i >= offset ? nat_low - tot.low_before
                                        : nat_low + tot.low_total - tot.low_before;
        const int feas_cum = i >= offset ? nat_feas - tot.feas_before
                                         : nat_feas + tot.feas_total - tot.feas_before;
        const bool skipped = low && low_cum <= kMaxSkip;
        const int skip_cum = low_cum < kMaxSkip ? low_cum : kMaxSkip;
        const bool ret = fv && !skipped;
        const int ret_excl = feas_cum - skip_cum - (int)ret;
        const bool pulled = i < n_real && ret_excl < limit;
        const bool src = ret && pulled;
        const int skip_excl = skip_cum - (int)skipped;
        const bool backlog = skipped && skip_excl < backlog_n;
        if (src || backlog) {
          const int rank = src ? ret_excl : ret_total + skip_excl;
          best = BestOp<Score>()(best, Best<Score>{fin, rank, i});
        }
        pulls_local += pulled;
      }
      nat_before += agg;
    }
    const Best<Score> win = ReduceBest(tmp.best).Reduce(best, BestOp<Score>());
    __syncthreads();
    Counts pc = {0, 0, 0, 0, pulls_local};
    const Counts pr = ReduceCounts(tmp.counts).Reduce(pc, CountsSum());

    // -- outputs and the carry update (engine.py:716-857), one thread ------
    if (tid == 0) {
      const bool any_cand = win.idx != kInt32Max;
      const int chosen = (any_cand && !skip) ? win.idx : -1;
      const bool success = chosen >= 0;
      const int pulls = skip ? 0 : pr.pulls;
      a.chosen[bP + p] = chosen;
      scores[p] = success ? win.score : (Score)0;
      a.pulls[bP + p] = pulls;
      a.skipped[bP + p] = skip ? 1 : 0;
      if (!skip) *offset_p = (offset + pulls) % nr;
      if (success) {
        const int ch = chosen;
        for (int d = 0; d < D; ++d) used[ch * D + d] = add_t(used[ch * D + d], asks[g * D + d]);
        tg_counts[(size_t)g * N + ch] += 1;
        job_counts[ch] += 1;
        for (int s = 0; s < S; ++s) {
          if (!spread_active[g * S + s]) continue;
          const size_t row = (size_t)g * S + s;
          const int vid = spread_vids[row * N + ch];
          if (vid >= 0 && vid < V) {
            spread_counts[row * V + vid] = add_t(spread_counts[row * V + vid], (T)1);
            spread_entry[row * V + vid] = 1;
          }
        }
        if constexpr (!kFloat) {
          const long long e0 = e_sel(e_base, e_ask_g, ch, 0);
          const long long e1 = e_sel(e_base, e_ask_g, ch, 1);
          e_base[ch * 2 + 0] = (int32_t)e0;
          e_base[ch * 2 + 1] = (int32_t)e1;
        }
        for (int d = 0; d < DP; ++d) {
          if (!dp_applies[g * DP + d]) continue;
          const int vid = dp_vids[(size_t)d * N + ch];
          if (vid >= 0 && vid < V2) dp_counts[d * V2 + vid] += 1;
        }
      }
      if constexpr (!kFloat) {
        // commit the eviction set where the chosen node did not fit
        // outright (engine.py:761-832)
        if (has_pre && success && !(scr_flags[chosen] & 4)) {
          const int ch = chosen;
          const int C = a.C;
          long long pen[kCMax];
          int8_t sel_ord[kCMax];
          int rank[kCMax];
          const PreRow row = pre_row(a, bNC, bN, ch, s_pre_counts, pen);
          greedy_row(ask3, row, sel_ord, nullptr);
          const uint32_t keep = second_pass_row(ask3, row, sel_ord, rank);
          // the freed capacity credits used after the score terms; dims
          // past 4 free nothing
          int32_t freed4[4] = {0, 0, 0, 0};
          long long freed3[3] = {0, 0, 0};
          long long eb[2] = {(long long)e_base[ch * 2 + 0], (long long)e_base[ch * 2 + 1]};
          const size_t base = bNC + (size_t)ch * C;
          int32_t* ev_row = a.evict_out + (bP + p) * C;
          for (int c = 0; c < C; ++c) {
            if (!((keep >> c) & 1u)) continue;
            for (int d = 0; d < 4; ++d) freed4[d] += row.res[c * 4 + d];
            for (int d = 0; d < 3; ++d) freed3[d] += row.res[c * 4 + d];
            // the running Q27 product in slot order (not associative)
            for (int d = 0; d < 2; ++d) eb[d] = (eb[d] * (long long)a.pre_evf[(base + c) * 2 + d]) >> kE27Bits;
            a.pre_alive[base + c] = 0;
            const int gid = a.pre_gid[base + c];
            if (gid >= 0 && gid < a.GP) a.pre_counts[(size_t)b * a.GP + gid] += 1;
            ev_row[c] = rank[c];
          }
          for (int d = 0; d < 4; ++d) used[ch * D + d] -= freed4[d];
          e_base[ch * 2 + 0] = (int32_t)eb[0];
          e_base[ch * 2 + 1] = (int32_t)eb[1];
          long long* rem = a.pre_remaining + (bN + ch) * 3;
          for (int d = 0; d < 3; ++d) rem[d] += freed3[d];
        }
      }
      if (do_evict && !success) {  // revert the eviction
        for (int d = 0; d < D; ++d) used[ev_node * D + d] = add_t(used[ev_node * D + d], evict_res[p * D + d]);
        job_counts[ev_node] += 1;
        if (dec_tg) {
          tg_counts[ev_tg * N + ev_node] += 1;
          for (int s = 0; s < S; ++s) {
            if (!spread_active[ev_tg * S + s]) continue;
            const int vid = spread_vids[((size_t)ev_tg * S + s) * N + ev_node];
            if (vid >= 0 && vid < V) {
              T& c = spread_counts[((size_t)ev_tg * S + s) * V + vid];
              c = add_t(c, (T)1);
            }
          }
        }
        if constexpr (!kFloat) {
          for (int d = 0; d < 2; ++d)
            e_base[ev_node * 2 + d] =
                (int32_t)(((long long)e_base[ev_node * 2 + d] * rev_factor[p * 2 + d]) >> kE27Bits);
        }
      }
      const bool unforced = !a.has_forced || fnode < 0;
      if (!success && !skip && unforced) failed[g] = 1;
    }
    __syncthreads();
  }
}

template <typename T>
int launch(const ScanArgs* args, void* stream) {
  if (args->B == 0 || args->P == 0) return 0;
  if (args->has_pre && (args->C > kCMax || args->GP > kGpMax)) return (int)cudaErrorInvalidValue;
  const size_t smem = sizeof(SpreadStat<typename Arm<T>::Count>) * (size_t)args->S;
  place_scan_kernel<T><<<args->B, kThreads, smem, (cudaStream_t)stream>>>(*args);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" int place_scan_launch(const ScanArgs* args, void* stream) {
  return launch<int32_t>(args, stream);
}

extern "C" int place_scan_f32_launch(const ScanArgs* args, void* stream) {
  return launch<float>(args, stream);
}

extern "C" const char* place_scan_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}

extern "C" int place_scan_args_size() { return (int)sizeof(ScanArgs); }
