// Node-sharded placement scan, both arms: one launch a (node shard,
// phase, step), every exchange between shards carried between launches.
//
// Replaces, for a mesh with a "nodes" axis, the XLA programs of
// nomad_tpu/tpu/engine.py under the reference's node shardings
// (nomad_tpu/parallel/sharding.py:41-93):
//   _make_step          (K1, :213)  one placement over a shard's nodes
//   _build_place_scan   (K2, :869)  the loop over P: the host's phase loop
//   _build_batched_scan (K3, :1000) the eval group: a block per eval
// in both arms, with the preemption branch (has_pre, engine.py:383-409,
// :761-832) through common.cuh's greedy_half, second_pass_half, isqrt64
// and coord_q (K6-K8). The plain version is tpu/node_shard.py; the host
// side (the slices, the partial buffers, the phase loop) is
// kernels.NodeShard / place_scan_nodes_phase and
// tpu/batcher.ShardLauncher.
//
// Shape of the work. A shard holds the slice [lo, lo + N) of every node
// axis of its eval group (B evals) and a replica of everything else
// (spread counts and entries, distinct_property counts, the ring offset,
// the failed flags, the preemption counts), each in its own buffer on
// its own device. A step is three launches a shard, each a block of 512
// threads per eval looping over the slice:
//   phase 0 (A): take in the gathered partials 3 (the previous step's
//     evicted slots' count groups, from their owner) into pre_counts;
//     evict the step's previous alloc (owner: used, counts, e_base;
//     every shard: its spread-count replica, with the replicated value
//     ids ev_vids); per-spread statistics; pass 1 (feasibility and the
//     score of every node of the slice into scratch, the greedy of
//     has_pre over the rows it can decide, a row a half-warp); the
//     slice's counts of (low, feasible) and of those before the ring
//     offset: this shard's row of partials 1;
//   phase 1 (B): every shard sums the gathered partials 1 to the same
//     totals and its own prefix (the lower shards'); pass 2 (the ring
//     cumsums from a block scan of contiguous runs, the limit window,
//     the (max score, min rank, first index) candidate) over the slice:
//     its row of partials 2, with the best node's fits bit and value ids
//     and the slice's pull count;
//   phase 2 (C): every shard reduces the gathered partials 2 to the same
//     winner and pull count; the owner commits to its slice, every shard
//     to its replicas; shard 0 writes the step's outputs; on an eviction
//     step the owner's half-warp runs the second pass and writes the
//     evicted slots' groups as its row of partials 3 (every other row
//     -1); the revert of a failed step's eviction; the failed flag.
// Between phases the host copies each shard's row into every other
// shard's gathered buffer on the shard's stream, and each shard's stream
// waits on the others' events before its next phase. No launch waits on
// memory another launch writes: nothing here spins or polls; a launch
// reads only what stream order made complete before it started.
//
// What bounds it on an H100: not bytes or operations (the work is K3's,
// kernels.place_scan_batched_work) but the launches: 3 a step a shard,
// each a few microseconds of one SM per eval, and the host's loop that
// enqueues them with the copies and events between shards. Holding the
// state in global memory between launches costs little beside that.
//
// Hold points, as place_scan.cu's: floor division of possibly negative
// int64, arithmetic '>>' of negative int64, neg_inf = INT64_MIN / 4; in
// the float arm every operation rounds on its own (__f*_rn), pow(10, x)
// is powf, spread_total sums s = 0..S-1 in index order. The selection is
// a total order (first index among ties), and the counts are integers,
// so no float sum crosses shards: both arms equal the unsharded scan bit
// for bit. The per-node arithmetic of pass 1 is place_scan.cu's, kept in
// this file so that K3's source stays as it is.

#include <cstdint>
#include <cuda_runtime.h>

#include "common.cuh"

using namespace nomad;

namespace {

constexpr int kThreads = 512;
constexpr int kWarps = kThreads / 32;
constexpr int kMaxSkip = 3;
constexpr long long kBigFp = 1LL << 44;
constexpr long long kLarge = 1LL << 40;
constexpr long long kNegInf = -(1LL << 61);  // jnp.iinfo(int64).min // 4
constexpr int kInt32Max = 2147483647;
constexpr float kF32Big = 3.40282347e+38f / 16.0f;  // finfo(f32).max / 16
// node_shard.W1 and W2_FIXED: partial 1's width, partial 2's fixed words
constexpr int kW1 = 4;
constexpr int kW2Fixed = 6;

// a node's flags within a step (scratch, from phase A to B and C)
constexpr uint8_t kFeasMask = 1;  // every mask but capacity
constexpr uint8_t kFits = 2;      // fits outright
constexpr uint8_t kMet = 4;       // the greedy meets the ask
constexpr uint8_t kFeasV = 8;     // feasible (capacity or rescue) and real
constexpr uint8_t kLow = 16;      // feasible with a score <= 0

}  // namespace

// Mirrors NodesArgs in kernels.py field for field. Node-axis arrays are
// the shard's slices ([B, ..., N, ...]); the rest are whole. Arrays
// marked T hold int32 in the int arm and float32 in the float arm; S
// holds int64 and float32 respectively.
struct NodesArgs {
  int B, N, D, G, S, V, K, DP, V2, P;
  int has_reserved, has_aff, has_evict, has_forced;
  int has_pre, C, GP;
  int lo, nodes, shard, W2;  // slice start, shards, this shard, partial 2's width
  // static
  const void* totals;             // T [B,N,D]
  const void* reserved;           // T [B,N,D] when has_reserved
  const void* asks;               // T [B,G,D]
  const uint8_t* feat;            // [B,G,N]
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
  void* spread_counts;            // T [B,G,S,V] replica
  uint8_t* spread_entry;          // [B,G,S,V] replica
  int32_t* offset;                // [B] replica
  uint8_t* failed;                // [B,G] replica
  int32_t* e_base;                // [B,N,2] int arm
  int32_t* dp_counts;             // [B,DP,V2] replica
  // per placement (replicated)
  const int32_t* tg_idx;          // [B,P]
  const int32_t* penalty_idx;     // [B,P,K] global node indices
  const int32_t* evict_node;      // [B,P] global
  const void* evict_res;          // T [B,P,D] when has_evict
  const int32_t* evict_tg;        // [B,P]
  const int32_t* limit_p;         // [B,P]
  const void* sum_sw_p;           // T [B,P]
  const int32_t* ev_factor;       // [B,P,2] when has_evict (int arm)
  const int32_t* rev_factor;      // [B,P,2] when has_evict (int arm)
  const int32_t* forced_node;     // [B,P,1] when has_forced, global
  // outputs (shard 0 writes the step's; the owner the evict rows)
  int32_t* chosen;                // [B,P] global
  void* scores;                   // S [B,P]
  int32_t* pulls;                 // [B,P]
  uint8_t* skipped;               // [B,P]
  // preemption (has_pre, int arm)
  const int32_t* pre_res;         // [B,N,C,4], 16-byte aligned
  const int32_t* pre_prio;        // [B,N,C]
  const uint8_t* pre_elig;        // [B,N,C]
  const int32_t* pre_mp;          // [B,N,C]
  const int32_t* pre_gid;         // [B,N,C]
  const int32_t* pre_evf;         // [B,N,C,2]
  uint8_t* pre_alive;             // [B,N,C]
  long long* pre_remaining;       // [B,N,3]
  int32_t* pre_counts;            // [B,GP] replica
  int32_t* evict_out;             // [B,P,C]
  const int32_t* ev_vids;         // [B,P,S] the evicted node's spread value ids
  // scratch, from phase A to phases B and C
  void* score;                    // S [B,N]
  uint8_t* flags;                 // [B,N]
  int8_t* sel_ord;                // [B,N,16] the greedy's round of each slot
  void* stat;                     // SpreadStat [B,S]
  // gathered partials [nodes,B,W]: row `shard` is this shard's own
  int32_t* gath1;                 // W = 4
  int32_t* gath2;                 // W = W2
  int32_t* gath3;                 // W = C
};

namespace {

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
  int fits;
};

template <typename Score>
__device__ __forceinline__ Best<Score> best_op(const Best<Score>& a, const Best<Score>& b) {
  if (a.score != b.score) return a.score > b.score ? a : b;
  if (a.rank != b.rank) return a.rank < b.rank ? a : b;
  return a.idx <= b.idx ? a : b;
}

// the best (best_op) over the lanes of a warp, on every lane
template <typename Score>
__device__ __forceinline__ Best<Score> warp_best(Best<Score> v) {
  for (int o = 16; o > 0; o >>= 1) {
    Best<Score> w;
    w.score = __shfl_xor_sync(0xffffffffu, v.score, o);
    w.rank = __shfl_xor_sync(0xffffffffu, v.rank, o);
    w.idx = __shfl_xor_sync(0xffffffffu, v.idx, o);
    w.fits = __shfl_xor_sync(0xffffffffu, v.fits, o);
    v = best_op(v, w);
  }
  return v;
}

// a score's two words in partial 2: the int64, low word first; the f32's bits, then 0
__device__ __forceinline__ void score_words(long long s, int32_t* w) {
  w[0] = (int32_t)(unsigned long long)s;
  w[1] = (int32_t)(s >> 32);
}
__device__ __forceinline__ void score_words(float s, int32_t* w) {
  w[0] = __float_as_int(s);
  w[1] = 0;
}
template <typename Score> __device__ __forceinline__ Score score_of(const int32_t* w);
template <> __device__ __forceinline__ long long score_of<long long>(const int32_t* w) {
  return (long long)(((unsigned long long)(uint32_t)w[1] << 32) | (unsigned long long)(uint32_t)w[0]);
}
template <> __device__ __forceinline__ float score_of<float>(const int32_t* w) {
  return __int_as_float(w[0]);
}

template <typename C>
struct Entries {
  C min_c, max_c;
  int any;
};

template <typename C>
__device__ __forceinline__ Entries<C> entries_op(const Entries<C>& a, const Entries<C>& b) {
  return {a.min_c < b.min_c ? a.min_c : b.min_c, a.max_c > b.max_c ? a.max_c : b.max_c,
          a.any | b.any};
}

template <typename C>
struct SpreadStat {
  C min_c, max_c;
  long long r_min;  // int arm: the Q45 reciprocal of min_c
  int has_entries;
};
static_assert(sizeof(SpreadStat<long long>) <= 32, "kernels.NODE_STAT_BYTES");
static_assert(sizeof(SpreadStat<float>) <= 32, "kernels.NODE_STAT_BYTES");

// slot c of one node row (base: the row's first slot) on lane c of a
// half-warp, with its max_parallel penalty from the shard's pre_counts
__device__ __forceinline__ PreSlot load_slot(const NodesArgs& a, size_t base, int c,
                                             const int32_t* pre_counts) {
  PreSlot s;
  s.alive = false;
  s.prio = kInt32Max;
  s.pen = 0;
  s.res[0] = s.res[1] = s.res[2] = 0;
  if (c < a.C) {
    const int4 r = *reinterpret_cast<const int4*>(a.pre_res + (base + c) * 4);
    s.res[0] = r.x;
    s.res[1] = r.y;
    s.res[2] = r.z;
    s.prio = a.pre_prio[base + c];
    const int gid = a.pre_gid[base + c];
    const int mp = a.pre_mp[base + c];
    const int num = (gid >= 0 && gid < a.GP) ? pre_counts[gid] : 0;
    s.pen = (mp > 0 && num >= mp) ? (long long)((num + 1) - mp) * kPenaltyUnit * kCqOne : 0;
    s.alive = a.pre_alive[base + c] && a.pre_elig[base + c];
  }
  return s;
}

// The step's replicated inputs.
struct StepIn {
  int g, limit, ev_node_raw, ev_tg_raw, fnode;
  int32_t sum_sw_bits;
};

__device__ __forceinline__ StepIn step_in(const NodesArgs& a, int b, int p) {
  const size_t i = (size_t)b * a.P + p;
  StepIn s;
  s.g = a.tg_idx[i];
  s.limit = a.limit_p[i];
  s.ev_node_raw = a.evict_node[i];
  s.ev_tg_raw = a.evict_tg[i];
  s.fnode = a.has_forced ? a.forced_node[i] : -1;
  s.sum_sw_bits = reinterpret_cast<const int32_t*>(a.sum_sw_p)[i];
  return s;
}

// the previous alloc's eviction (sign -1) or its revert (+1): the owner's
// slice, and this shard's spread-count replica (thread 0)
template <typename T>
__device__ void evict_counts(const NodesArgs& a, int b, int p, const StepIn& in, int sign) {
  constexpr bool kFloat = Arm<T>::kFloat;
  const int N = a.N, D = a.D, G = a.G, S = a.S, V = a.V;
  const int ev_node = in.ev_node_raw > 0 ? in.ev_node_raw : 0;
  const int ev_tg = in.ev_tg_raw > 0 ? in.ev_tg_raw : 0;
  const bool dec_tg = in.ev_tg_raw >= 0;
  const int li = ev_node - a.lo;
  const size_t bP = (size_t)b * a.P;
  if (li >= 0 && li < N) {
    T* used = static_cast<T*>(a.used) + ((size_t)b * N + li) * D;
    const T* res = static_cast<const T*>(a.evict_res) + (bP + p) * D;
    for (int d = 0; d < D; ++d) used[d] = sign < 0 ? sub_t(used[d], res[d]) : add_t(used[d], res[d]);
    a.job_counts[(size_t)b * N + li] += sign;
    if (dec_tg) a.tg_counts[((size_t)b * G + ev_tg) * N + li] += sign;
    if constexpr (!kFloat) {
      const int32_t* f = (sign < 0 ? a.ev_factor : a.rev_factor) + (bP + p) * 2;
      int32_t* eb = a.e_base + ((size_t)b * N + li) * 2;
      for (int d = 0; d < 2; ++d) eb[d] = (int32_t)(((long long)eb[d] * f[d]) >> kE27Bits);
    }
  }
  if (dec_tg) {
    T* sc = static_cast<T*>(a.spread_counts) + (size_t)b * G * S * V;
    for (int s = 0; s < S; ++s) {
      if (!a.spread_active[((size_t)b * G + ev_tg) * S + s]) continue;
      const int vid = a.ev_vids[(bP + p) * S + s];
      if (vid >= 0 && vid < V) {
        T& c = sc[((size_t)ev_tg * S + s) * V + vid];
        c = sign < 0 ? sub_t(c, (T)1) : add_t(c, (T)1);
      }
    }
  }
}

// -- phase A ---------------------------------------------------------------

template <typename T>
__device__ void phase_a(const NodesArgs& a, int b, int p) {
  using Score = typename Arm<T>::Score;
  using Count = typename Arm<T>::Count;
  constexpr bool kFloat = Arm<T>::kFloat;
  __shared__ int s_wcnt[kWarps][4];
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int N = a.N, D = a.D, G = a.G, S = a.S, V = a.V, K = a.K, DP = a.DP, V2 = a.V2;
  const int C = a.C, lo = a.lo;
  const bool has_pre = !kFloat && a.has_pre;
  int32_t* pre_counts = a.pre_counts + (size_t)b * a.GP;
  // exchange 3 in: the evicted slots' count groups of the previous step
  if (has_pre && tid == 0) {
    for (int r = 0; r < a.nodes; ++r) {
      const int32_t* row = a.gath3 + ((size_t)r * a.B + b) * C;
      for (int c = 0; c < C; ++c) {
        const int gid = row[c];
        if (gid >= 0 && gid < a.GP) pre_counts[gid] += 1;
      }
    }
  }
  if (p >= a.P) return;
  const StepIn in = step_in(a, b, p);
  const int g = in.g;
  if (a.failed[(size_t)b * G + g]) return;  // a skipped step: every shard alike
  const bool do_evict = a.has_evict && in.ev_node_raw >= 0;
  if (tid == 0 && do_evict) evict_counts<T>(a, b, p, in, -1);
  __syncthreads();

  const size_t bN = (size_t)b * N;
  const size_t bG = (size_t)b * G;
  const T* asks = static_cast<const T*>(a.asks) + bG * D;
  const T* sc = static_cast<const T*>(a.spread_counts) + bG * S * V;
  const uint8_t* se = a.spread_entry + bG * S * V;
  const T* sd = static_cast<const T*>(a.spread_desired) + bG * S * V;
  const T* sw = static_cast<const T*>(a.spread_weights) + bG * S;
  const uint8_t* sact = a.spread_active + bG * S;
  const uint8_t* stgt = a.spread_has_targets + bG * S;
  SpreadStat<Count>* stat = static_cast<SpreadStat<Count>*>(a.stat) + (size_t)b * S;
  const int invalid_bucket = V - 1;

  // per-spread entry statistics (engine.py:469, :522-532, :601-605)
  for (int s = warp; s < S; s += kWarps) {
    if (!(sact[g * S + s] && !stgt[g * S + s])) continue;
    const size_t row = ((size_t)g * S + s) * V;
    Entries<Count> e;
    if constexpr (kFloat) {
      e = {INFINITY, -INFINITY, 0};
    } else {
      e = {kLarge, -kLarge, 0};
    }
    for (int v = lane; v < invalid_bucket; v += 32) {
      if (se[row + v]) {
        const Count c = sc[row + v] > 0 ? (Count)sc[row + v] : (Count)0;
        e = entries_op(e, Entries<Count>{c, c, 1});
      }
    }
    for (int o = 16; o > 0; o >>= 1)
      e = entries_op(e, Entries<Count>{__shfl_xor_sync(0xffffffffu, e.min_c, o),
                                       __shfl_xor_sync(0xffffffffu, e.max_c, o),
                                       __shfl_xor_sync(0xffffffffu, e.any, o)});
    if (lane == 0) {
      SpreadStat<Count> st;
      st.has_entries = e.any;
      st.min_c = e.any ? e.min_c : (Count)0;
      st.max_c = e.any ? e.max_c : (Count)0;
      st.r_min = 0;
      if constexpr (!kFloat) st.r_min = (1LL << kRecipBits) / (st.min_c > 1 ? st.min_c : 1);
      stat[s] = st;
    }
  }
  __syncthreads();

  // pass 1: feasibility and score of every node of the slice
  const int n_real = a.n_real[b];
  const int offset = a.offset[b];
  const bool dh_job_g = a.dh_job[bG + g] != 0;
  const bool dh_tg_g = a.dh_tg[bG + g] != 0;
  const int desired_i = a.desired[bG + g];
  const long long q_d = (1LL << kRecipBits) / (desired_i > 1 ? desired_i : 1);
  const float desired_f = (float)desired_i;
  T in_sum_sw;
  if constexpr (kFloat) {
    in_sum_sw = __int_as_float(in.sum_sw_bits);
  } else {
    in_sum_sw = in.sum_sw_bits;
  }
  const T* used = static_cast<const T*>(a.used) + bN * D;
  const T* totals = static_cast<const T*>(a.totals) + bN * D;
  const T* reserved = a.has_reserved ? static_cast<const T*>(a.reserved) + bN * D : nullptr;
  const int32_t* tgc = a.tg_counts + (bG + g) * N;
  const int32_t* jobc = a.job_counts + bN;
  const uint8_t* feat = a.feat + (bG + g) * N;
  const T* aff = a.has_aff ? static_cast<const T*>(a.aff_score) + (bG + g) * N : nullptr;
  const int32_t* svids = a.spread_vids + (bG + g) * S * N;
  const int32_t* dpv = a.dp_vids + (size_t)b * DP * N;
  const int32_t* dp = a.dp_counts + (size_t)b * DP * V2;
  const int32_t* dp_limit = a.dp_limit + (size_t)b * DP;
  const uint8_t* dp_applies = a.dp_applies + (bG + g) * DP;
  const int32_t* ebase = kFloat ? nullptr : a.e_base + bN * 2;
  const int32_t* ea = kFloat ? nullptr : a.e_ask + (bG + g) * N * 2;
  const int32_t* penalty = a.penalty_idx + ((size_t)b * a.P + p) * K;
  Score* score = static_cast<Score*>(a.score) + bN;
  uint8_t* flags = a.flags + bN;
  for (int li = tid; li < N; li += kThreads) {
    const int i = lo + li;
    bool fits = true;
    T util_cm[2] = {(T)0, (T)0};
    for (int d = 0; d < D; ++d) {
      T util = used[li * D + d];
      if constexpr (kFloat) {
        // (used + reserved) + ask, engine.py:362
        if (reserved) util = __fadd_rn(util, reserved[li * D + d]);
        util = __fadd_rn(util, asks[g * D + d]);
      } else {
        util += asks[g * D + d];
        if (reserved) util += reserved[li * D + d];
      }
      if (d < 2) util_cm[d] = util;
      fits = fits && util <= totals[li * D + d];
    }
    const int tgc_i = tgc[li];
    const int jc = jobc[li];
    const bool dh = dh_job_g ? (jc == 0) : (dh_tg_g ? !(tgc_i > 0 && jc > 0) : true);
    const uint8_t fbits = feat[li];
    bool feasible = (fbits & 1) && dh;
    if (a.has_forced) feasible = feasible && (in.fnode < 0 || i == in.fnode);
    for (int d = 0; d < DP; ++d) {
      const int vid = dpv[(size_t)d * N + li];
      int c = 0;
      if (vid >= 0 && vid < V2) c = dp[d * V2 + vid] > 0 ? dp[d * V2 + vid] : 0;
      const bool applies = dp_applies[d] != 0;
      const bool missing = vid == V2 - 1;
      feasible = feasible && (!applies || (!missing && c < dp_limit[d]));
    }
    bool pmask = false;
    for (int k = 0; k < K; ++k) pmask = pmask || penalty[k] == i;
    const bool anti_present = tgc_i > 0;
    const bool aff_p = aff != nullptr && ((fbits >> 1) & 1);

    Score final_score;
    if constexpr (kFloat) {
      // engine.py:576-581
      const float node_c = reserved ? __fsub_rn(totals[li * D + 0], reserved[li * D + 0]) : totals[li * D + 0];
      const float node_m = reserved ? __fsub_rn(totals[li * D + 1], reserved[li * D + 1]) : totals[li * D + 1];
      const float binpack = binpack_f32(util_cm[0], util_cm[1], node_c, node_m);
      const float anti = anti_f32(anti_present, tgc_i, desired_f);
      const float resched = pmask ? -1.f : 0.f;
      const float affv = aff_p ? aff[li] : 0.f;
      float spread_total = 0.f;
      for (int s = 0; s < S; ++s) {
        float per_s = 0.f;
        if (sact[g * S + s]) {
          const size_t row = (size_t)g * S + s;
          const int vid = svids[(size_t)s * N + li];
          const bool inr = vid >= 0 && vid < V;
          float cur = 0.f, dd = 0.f;
          if (inr) {
            cur = sc[row * V + vid] > 0.f ? sc[row * V + vid] : 0.f;
            dd = sd[row * V + vid];
          }
          if (vid == invalid_bucket) {
            per_s = -1.f;
          } else if (stgt[g * S + s]) {
            if (dd > 0.f) {
              const float wf = __fdiv_rn(sw[g * S + s], max_keep_nan(in_sum_sw, kEps));
              per_s = __fmul_rn(__fdiv_rn(__fsub_rn(dd, __fadd_rn(cur, 1.f)), dd), wf);
            } else {
              per_s = dd == 0.f ? -kF32Big : -1.f;
            }
          } else {
            const SpreadStat<Count> st = stat[s];
            if (!st.has_entries) {
              per_s = 0.f;
            } else if (cur != st.min_c) {
              per_s = st.min_c == 0.f ? -1.f
                                      : __fdiv_rn(__fsub_rn(st.min_c, cur), max_keep_nan(st.min_c, kEps));
            } else if (st.min_c == st.max_c) {
              per_s = -1.f;
            } else if (st.min_c == 0.f) {
              per_s = 1.f;
            } else {
              per_s = __fdiv_rn(__fsub_rn(st.max_c, st.min_c), max_keep_nan(st.min_c, kEps));
            }
          }
        }
        spread_total = __fadd_rn(spread_total, per_s);
      }
      const int num_terms = 1 + (int)anti_present + (int)pmask + (int)aff_p + (int)(spread_total != 0.f);
      float sum = __fadd_rn(binpack, anti);
      sum = __fadd_rn(sum, resched);
      sum = __fadd_rn(sum, affv);
      sum = __fadd_rn(sum, spread_total);
      final_score = __fdiv_rn(sum, (float)num_terms);
    } else {
      const long long sw64 = in_sum_sw > 1 ? (long long)in_sum_sw : 1LL;
      const long long binpack = binpack_q30(e_sel(ebase, ea, li, 0), e_sel(ebase, ea, li, 1));
      const long long anti = anti_q30(anti_present, tgc_i, q_d);
      const long long resched = pmask ? -kTermOne : 0;
      const long long affv = aff_p ? (long long)aff[li] : 0;
      long long spread_total = 0;
      for (int s = 0; s < S; ++s) {
        if (!sact[g * S + s]) continue;
        const size_t row = (size_t)g * S + s;
        const int vid = svids[(size_t)s * N + li];
        const bool inr = vid >= 0 && vid < V;
        long long cur = 0, dd = 0;
        if (inr) {
          cur = sc[row * V + vid] > 0 ? sc[row * V + vid] : 0;
          dd = sd[row * V + vid];
        }
        long long per_s;
        if (vid == invalid_bucket) {
          per_s = -kTermOne;
        } else if (stgt[g * S + s]) {
          if (dd > 0) {
            const long long t_num = (dd - 100 * (cur + 1)) * (long long)sw[g * S + s] * kTermOne;
            per_s = floordiv_pos(t_num, dd * sw64);
          } else {
            per_s = dd == 0 ? -kBigFp : -kTermOne;
          }
        } else {
          const SpreadStat<Count> st = stat[s];
          if (!st.has_entries) {
            per_s = 0;
          } else if (cur != st.min_c) {
            per_s = st.min_c == 0 ? -kTermOne : (((st.min_c - cur) * st.r_min) >> kRsh);
          } else if (st.min_c == st.max_c) {
            per_s = -kTermOne;
          } else if (st.min_c == 0) {
            per_s = kTermOne;
          } else {
            per_s = ((st.max_c - st.min_c) * st.r_min) >> kRsh;
          }
        }
        spread_total += per_s;
      }
      const int num_terms = 1 + (int)anti_present + (int)pmask + (int)aff_p + (int)(spread_total != 0);
      const long long factor = 60 / num_terms;
      final_score = (binpack + anti + resched + affv + spread_total) * factor;
    }
    score[li] = final_score;
    flags[li] = (uint8_t)((feasible ? kFeasMask : 0) | (fits ? kFits : 0));
  }

  if constexpr (!kFloat) {
    if (has_pre) {
      // the greedy on the rows where it can decide cap_ok = fits | met, a
      // row a half-warp, a slot a lane
      __syncthreads();
      long long ask3[3];
      for (int d = 0; d < 3; ++d) ask3[d] = (long long)asks[g * D + d];
      const int c = tid & 15;
      const unsigned hmask = 0xffffu << (tid & 16);
      for (int li = tid >> 4; li < N; li += kThreads / 16) {
        const uint8_t f = flags[li];
        if (!((f & kFeasMask) && !(f & kFits) && lo + li < n_real)) continue;
        const size_t node = bN + li;
        const PreSlot slot = load_slot(a, node * C, c, pre_counts);
        const long long rem[3] = {a.pre_remaining[node * 3 + 0], a.pre_remaining[node * 3 + 1],
                                  a.pre_remaining[node * 3 + 2]};
        int sel;
        const bool met = greedy_half(ask3, rem, slot, C, hmask, &sel);
        if (met && c == 0) flags[li] = (uint8_t)(f | kMet);
        a.sel_ord[node * 16 + c] = (int8_t)sel;
      }
    }
  }
  __syncthreads();

  // the slice's counts: this shard's row of partials 1
  int cnt[4] = {0, 0, 0, 0};
  for (int li = tid; li < N; li += kThreads) {
    const int i = lo + li;
    const uint8_t f = flags[li];
    const bool feas_v = (f & kFeasMask) && (f & (kFits | kMet)) && i < n_real;
    const bool low = feas_v && score[li] <= (Score)0;
    flags[li] = (uint8_t)(f | (feas_v ? kFeasV : 0) | (low ? kLow : 0));
    cnt[0] += low;
    cnt[1] += feas_v;
    if (i < offset) {
      cnt[2] += low;
      cnt[3] += feas_v;
    }
  }
  for (int k = 0; k < 4; ++k) {
    const int v = __reduce_add_sync(0xffffffffu, cnt[k]);
    if (lane == 0) s_wcnt[warp][k] = v;
  }
  __syncthreads();
  if (tid < 4) {
    int v = 0;
    for (int w = 0; w < kWarps; ++w) v += s_wcnt[w][tid];
    a.gath1[((size_t)a.shard * a.B + b) * kW1 + tid] = v;
  }
}

// -- phase B ---------------------------------------------------------------

template <typename T>
__device__ void phase_b(const NodesArgs& a, int b, int p) {
  using Score = typename Arm<T>::Score;
  __shared__ int s_wtot[kWarps][2];
  __shared__ Best<Score> s_wbest[kWarps];
  __shared__ int s_wpulls[kWarps];
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int N = a.N, lo = a.lo;
  const StepIn in = step_in(a, b, p);
  const int g = in.g;
  if (a.failed[(size_t)b * a.G + g]) return;
  // exchange 1 in: the same totals on every shard, this shard's prefix
  int tot[4] = {0, 0, 0, 0}, pfx[2] = {0, 0};
  for (int r = 0; r < a.nodes; ++r) {
    const int32_t* row = a.gath1 + ((size_t)r * a.B + b) * kW1;
    for (int k = 0; k < 4; ++k) tot[k] += row[k];
    if (r < a.shard) {
      pfx[0] += row[0];
      pfx[1] += row[1];
    }
  }
  const int n_real = a.n_real[b];
  const int offset = a.offset[b];
  const int limit = in.limit;
  const int ret_total = tot[1] - (tot[0] < kMaxSkip ? tot[0] : kMaxSkip);
  const int backlog_n = limit - ret_total > 0 ? limit - ret_total : 0;
  const size_t bN = (size_t)b * N;
  const Score* score = static_cast<const Score*>(a.score) + bN;
  const uint8_t* flags = a.flags + bN;

  // a contiguous run of the slice a thread; the block's exclusive scan of
  // the runs' (low, feasible) counts
  const int run = (N + kThreads - 1) / kThreads;
  const int l0 = min(tid * run, N);
  const int l1 = min(l0 + run, N);
  int own[2] = {0, 0};
  for (int li = l0; li < l1; ++li) {
    own[0] += (flags[li] & kLow) ? 1 : 0;
    own[1] += (flags[li] & kFeasV) ? 1 : 0;
  }
  int inc[2] = {own[0], own[1]};
  for (int o = 1; o < 32; o <<= 1) {
    for (int k = 0; k < 2; ++k) {
      const int up = __shfl_up_sync(0xffffffffu, inc[k], o);
      if (lane >= o) inc[k] += up;
    }
  }
  if (lane == 31) {
    s_wtot[warp][0] = inc[0];
    s_wtot[warp][1] = inc[1];
  }
  __syncthreads();
  int nat_low = pfx[0] + inc[0] - own[0];
  int nat_feas = pfx[1] + inc[1] - own[1];
  for (int w = 0; w < warp; ++w) {
    nat_low += s_wtot[w][0];
    nat_feas += s_wtot[w][1];
  }

  // pass 2: ring cumsums, limit window, selection (engine.py:660-723)
  Best<Score> best = {Arm<T>::neg_inf(), kInt32Max, kInt32Max, 0};
  int pulls = 0;
  for (int li = l0; li < l1; ++li) {
    const int i = lo + li;
    const uint8_t f = flags[li];
    const int low = (f & kLow) ? 1 : 0;
    const int fv = (f & kFeasV) ? 1 : 0;
    nat_low += low;
    nat_feas += fv;
    const int low_cum = i >= offset ? nat_low - tot[2] : nat_low + tot[0] - tot[2];
    const int feas_cum = i >= offset ? nat_feas - tot[3] : nat_feas + tot[1] - tot[3];
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
      best = best_op(best, Best<Score>{score[li], rank, i, (f & kFits) ? 1 : 0});
    }
    pulls += pulled;
  }
  best = warp_best(best);
  pulls = __reduce_add_sync(0xffffffffu, pulls);
  if (lane == 0) {
    s_wbest[warp] = best;
    s_wpulls[warp] = pulls;
  }
  __syncthreads();
  if (tid == 0) {
    Best<Score> v = s_wbest[0];
    int total = s_wpulls[0];
    for (int w = 1; w < kWarps; ++w) {
      v = best_op(v, s_wbest[w]);
      total += s_wpulls[w];
    }
    // this shard's row of partials 2: the best, its node's value ids
    int32_t* row = a.gath2 + ((size_t)a.shard * a.B + b) * a.W2;
    score_words(v.score, row);
    row[2] = v.rank;
    row[3] = v.idx;
    row[4] = v.fits;
    row[5] = total;
    const int li = v.idx - lo;
    const bool has = v.idx != kInt32Max && li >= 0 && li < N;
    for (int s = 0; s < a.S; ++s)
      row[kW2Fixed + s] = has ? a.spread_vids[(((size_t)b * a.G + g) * a.S + s) * N + li] : 0;
    for (int d = 0; d < a.DP; ++d)
      row[kW2Fixed + a.S + d] = has ? a.dp_vids[((size_t)b * a.DP + d) * N + li] : 0;
  }
}

// -- phase C ---------------------------------------------------------------

template <typename T>
__device__ void phase_c(const NodesArgs& a, int b, int p) {
  using Score = typename Arm<T>::Score;
  constexpr bool kFloat = Arm<T>::kFloat;
  __shared__ int s_win[4];  // chosen, fits, the winner's row, pulls
  const int tid = threadIdx.x;
  const int N = a.N, D = a.D, G = a.G, S = a.S, V = a.V, DP = a.DP, V2 = a.V2, C = a.C;
  const int lo = a.lo;
  const size_t bP = (size_t)b * a.P;
  const size_t bG = (size_t)b * G;
  const StepIn in = step_in(a, b, p);
  const int g = in.g;
  int32_t* part3 = a.gath3 + ((size_t)a.shard * a.B + b) * C;
  if (tid < C) part3[tid] = -1;
  Score* scores = static_cast<Score*>(a.scores) + bP;
  if (a.failed[bG + g]) {
    // a step of a failed task group (or a batch's padding) changes
    // nothing of the carry
    if (tid == 0 && a.shard == 0) {
      a.chosen[bP + p] = -1;
      scores[p] = (Score)0;
      a.pulls[bP + p] = 0;
      a.skipped[bP + p] = 1;
    }
    return;
  }
  const bool do_evict = a.has_evict && in.ev_node_raw >= 0;
  if (tid == 0) {
    // exchange 2 in: the same winner and pull count on every shard
    Best<Score> win = {Arm<T>::neg_inf(), kInt32Max, kInt32Max, 0};
    int win_row = -1, pulls = 0;
    for (int r = 0; r < a.nodes; ++r) {
      const int32_t* row = a.gath2 + ((size_t)r * a.B + b) * a.W2;
      pulls += row[5];
      if (row[3] == kInt32Max) continue;
      const Best<Score> v = {score_of<Score>(row), row[2], row[3], row[4]};
      if (win_row < 0 || best_op(win, v).idx == v.idx) {
        win = v;
        win_row = r;
      }
    }
    const int chosen = win_row >= 0 ? win.idx : -1;
    const bool success = chosen >= 0;
    const int n_real = a.n_real[b];
    const int nr = n_real > 1 ? n_real : 1;
    a.offset[b] = (a.offset[b] + pulls) % nr;
    if (a.shard == 0) {
      a.chosen[bP + p] = chosen;
      scores[p] = success ? win.score : (Score)0;
      a.pulls[bP + p] = pulls;
      a.skipped[bP + p] = 0;
    }
    const int li = chosen - lo;
    const bool own = success && li >= 0 && li < N;
    if (success) {
      const int32_t* vids = a.gath2 + ((size_t)win_row * a.B + b) * a.W2 + kW2Fixed;
      if (own) {
        T* used = static_cast<T*>(a.used) + ((size_t)b * N + li) * D;
        const T* asks = static_cast<const T*>(a.asks) + (bG + g) * D;
        for (int d = 0; d < D; ++d) used[d] = add_t(used[d], asks[d]);
        a.tg_counts[(bG + g) * N + li] += 1;
        a.job_counts[(size_t)b * N + li] += 1;
        if constexpr (!kFloat) {
          int32_t* ebase = a.e_base + (size_t)b * N * 2;
          const int32_t* ea = a.e_ask + (bG + g) * N * 2;
          const long long e0 = e_sel(ebase, ea, li, 0);
          const long long e1 = e_sel(ebase, ea, li, 1);
          ebase[li * 2 + 0] = (int32_t)e0;
          ebase[li * 2 + 1] = (int32_t)e1;
        }
      }
      T* sc = static_cast<T*>(a.spread_counts) + bG * S * V;
      uint8_t* se = a.spread_entry + bG * S * V;
      for (int s = 0; s < S; ++s) {
        if (!a.spread_active[bG * S + (size_t)g * S + s]) continue;
        const size_t row = (size_t)g * S + s;
        const int vid = vids[s];
        if (vid >= 0 && vid < V) {
          sc[row * V + vid] = add_t(sc[row * V + vid], (T)1);
          se[row * V + vid] = 1;
        }
      }
      int32_t* dp = a.dp_counts + (size_t)b * DP * V2;
      for (int d = 0; d < DP; ++d) {
        if (!a.dp_applies[(bG + g) * DP + d]) continue;
        const int vid = vids[S + d];
        if (vid >= 0 && vid < V2) dp[d * V2 + vid] += 1;
      }
    }
    if (do_evict && !success) evict_counts<T>(a, b, p, in, +1);
    const bool unforced = !a.has_forced || in.fnode < 0;
    if (!success && unforced) a.failed[bG + g] = 1;
    s_win[0] = chosen;
    s_win[1] = win.fits;
    s_win[2] = own ? 1 : 0;
  }
  if constexpr (!kFloat) {
    if (a.has_pre) {
      __syncthreads();
      const int chosen = s_win[0];
      // commit the eviction set where the chosen node did not fit outright
      // (engine.py:761-832): the owner's half-warp, a slot a lane
      if (chosen >= 0 && !s_win[1] && s_win[2] && tid < 16) {
        const int li = chosen - lo;
        const size_t node = (size_t)b * N + li;
        const size_t base = node * C;
        int32_t* pre_counts = a.pre_counts + (size_t)b * a.GP;
        const PreSlot slot = load_slot(a, base, tid, pre_counts);
        long long* rem_p = a.pre_remaining + node * 3;
        const long long rem[3] = {rem_p[0], rem_p[1], rem_p[2]};
        const T* asks = static_cast<const T*>(a.asks) + (bG + g) * D;
        const long long ask3[3] = {(long long)asks[0], (long long)asks[1], (long long)asks[2]};
        int rank;
        const bool keep = second_pass_half(ask3, rem, slot, a.sel_ord[node * 16 + tid], 0xffffu, &rank);
        const uint32_t kmask = __ballot_sync(0xffffu, keep) & 0xffffu;
        int res4 = 0, gid = -1, evf[2] = {0, 0};
        if (tid < C) {
          res4 = a.pre_res[(base + tid) * 4 + 3];
          gid = a.pre_gid[base + tid];
          evf[0] = a.pre_evf[(base + tid) * 2 + 0];
          evf[1] = a.pre_evf[(base + tid) * 2 + 1];
        }
        if (keep) {
          a.pre_alive[base + tid] = 0;
          a.evict_out[(bP + p) * C + tid] = rank;
        }
        // exchange 3 out: the evicted slots' count groups
        if (tid < C) part3[tid] = keep && gid >= 0 && gid < a.GP ? gid : -1;
        // the freed capacity credits used after the score terms (dims past
        // 4 free nothing); the Q27 product runs over the kept slots in slot
        // order (not associative)
        long long freed[4];
        for (int d = 0; d < 3; ++d) freed[d] = half_sum(keep ? slot.res[d] : 0, 0xffffu);
        freed[3] = half_sum(keep ? res4 : 0, 0xffffu);
        int32_t* ebase = a.e_base + node * 2;
        long long eb[2] = {(long long)ebase[0], (long long)ebase[1]};
        for (int c = 0; c < 16; ++c) {
          const long long f0 = __shfl_sync(0xffffu, evf[0], c, 16);
          const long long f1 = __shfl_sync(0xffffu, evf[1], c, 16);
          if ((kmask >> c) & 1u) {
            eb[0] = (eb[0] * f0) >> kE27Bits;
            eb[1] = (eb[1] * f1) >> kE27Bits;
          }
        }
        __syncwarp(0xffffu);
        if (tid == 0) {
          int32_t* used = static_cast<int32_t*>(a.used) + node * D;
          for (int d = 0; d < 4; ++d) used[d] -= (int32_t)freed[d];
          ebase[0] = (int32_t)eb[0];
          ebase[1] = (int32_t)eb[1];
          for (int d = 0; d < 3; ++d) rem_p[d] += freed[d];
        }
      }
    }
  }
}

template <typename T>
__global__ void __launch_bounds__(kThreads, 1) nodes_kernel(const NodesArgs a, int phase, int p) {
  const int b = blockIdx.x;
  if (phase == 0) {
    phase_a<T>(a, b, p);
  } else if (phase == 1) {
    phase_b<T>(a, b, p);
  } else {
    phase_c<T>(a, b, p);
  }
}

template <typename T>
int launch(const NodesArgs* args, int phase, int p, void* stream) {
  if (args->B == 0) return 0;
  if (phase < 0 || phase > 2 || p < 0 || p > args->P || (phase > 0 && p == args->P))
    return (int)cudaErrorInvalidValue;
  if (args->has_pre && (args->C > kCMax || args->GP > kGpMax)) return (int)cudaErrorInvalidValue;
  if (args->N < 1 || args->nodes < 1 || args->shard < 0 || args->shard >= args->nodes)
    return (int)cudaErrorInvalidValue;
  void* params[] = {const_cast<NodesArgs*>(args), &phase, &p};
  cudaError_t e = cudaLaunchKernel((const void*)nodes_kernel<T>, dim3(args->B), dim3(kThreads),
                                   params, 0, (cudaStream_t)stream);
  if (e != cudaSuccess) return (int)e;
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" int place_scan_nodes_launch(const NodesArgs* args, int phase, int p, void* stream) {
  return launch<int32_t>(args, phase, p, stream);
}

extern "C" int place_scan_nodes_f32_launch(const NodesArgs* args, int phase, int p, void* stream) {
  return launch<float>(args, phase, p, stream);
}

extern "C" const char* place_scan_nodes_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}

extern "C" int place_scan_nodes_args_size() { return (int)sizeof(NodesArgs); }
