// Placement scan, both arms: each eval's node axis over a thread-block
// cluster.
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
// here: counts and flags stay unpacked, and the results are the same bits.
//
// Shape of the work. The P placements of one eval depend on each other
// through the carry (used capacity, counts, the ring offset), so they run
// in order; evals are independent. The launch is B clusters of CS CTAs
// (cudaLaunchKernelEx with a cluster dimension), one cluster per eval.
// The launch plan (kernels.launch_plan) picks CS, a power of two up to 16
// (the largest with B x CS <= 132 SMs and at least 128 nodes a CTA), gives
// CTA r the contiguous node slice [r * per, (r + 1) * per) and lays out
// its dynamic shared memory, region by region (Region below):
//   - per CTA, always in shared memory: the step's score and flag of each
//     node of the slice, the per-spread statistics, the greedy's row list
//     and each row's greedy order, each task group's Q45 reciprocal;
//   - replicas of the small state every node reads (spread counts and
//     entries, distinct_property counts, the failed flags; the ring
//     offset and preemption counts in static shared memory): every CTA
//     keeps one and applies the same updates in the same order (the
//     step's eviction, the commit, the revert), so the per-spread
//     statistics and the skip decision are CTA-local;
//   - the task groups' inputs (asks, flags, spread weights and desired
//     counts, distinct_property tables) and the slice of each per-node
//     array (totals, reserved, features, Q27 exponentials, affinity,
//     spread and distinct_property value ids; the carried used, job and
//     task-group counts and e_base), copied in with cp.async once per
//     launch and updated in place by the steps; the carried ones are
//     written back at the end. An array the plan finds no room for stays
//     in global memory behind the same pointer (a replica, in a per-CTA
//     global arena), so there is one code path.
// Only the CTA that owns a node writes that node's entries. A step that
// ran copies the next step's scalars (task group, limit, eviction, forced
// node, spread weight sum) into shared memory by cp.async while it runs.
//
// A step:
//   1. the previous alloc's eviction (its owner and every replica), then
//      per-spread min/max/any over the value vocabulary (a warp a spread);
//   2. pass 1: feasibility and the score of every node of the slice, each
//      thread over a contiguous run of it, into shared memory. With a
//      candidate axis the rows where the greedy can decide cap_ok go to a
//      row list, and half-warps take the rows: lane c holds slot c, and a
//      greedy round costs one key per lane and (key, lane) reductions by
//      shuffles (common.cuh greedy_half);
//   3. the natural-order counts of (low, feasible) and of those before the
//      ring offset: one block scan of per-thread counts; exchange 1: lane r
//      of warp 0 stores the CTA's counts into CTA r's shared memory with
//      st.async (distributed shared memory, slot [step parity][rank]),
//      which counts the bytes on CTA r's transaction mbarrier; every
//      thread waits on its own CTA's mbarrier and sums the CS partials in
//      rank order: the same totals everywhere, and its CTA's prefix;
//   4. pass 2: the ring-ordered LimitIterator emulation and the (max
//      score, min rank, first index) selection over the slice, a block
//      reduction; exchange 2 the same way, the partial carrying its best
//      node's value ids for the commit; every thread reduces the CS
//      partials to the same winner (BestOp is a total order: the first
//      index among ties whatever the order) and the same pull count;
//   5. the commit: the chosen node's owner updates its entries, every CTA
//      its replicas. Preemption: pass 1 kept each greedy row's order in
//      shared memory; the owner runs the second pass over the chosen
//      row's (one half-warp), writes pre_alive / pre_remaining /
//      evict_out, and sends the evicted slots' count groups (a byte a
//      slot) to every CTA by st.async on a third transaction barrier,
//      waited on those steps only (every CTA knows them: the winner
//      carries its node's fits bit); every CTA counts them in its
//      pre_counts replica. (Every CTA recomputing the chosen row's
//      eviction set instead would read pre_alive / pre_remaining while
//      the owner rewrites them.)
// The exchanges use transaction barriers, not cluster barriers: a cluster
// barrier's acquire also drops the SM's L1 lines of global memory and
// took about twice the latency on an H100 (section timing), where a phase
// here completes when its one local arrival (armed with the bytes the
// partials bring) and those bytes are in. The slots are double-buffered
// by parity and each barrier completes one phase per exchange, so no
// further barrier guards their reuse: a CTA stores into a slot of that
// parity again only after every CTA has sent it the exchange in between,
// which each sends after reading its slots. Skipped steps (a failed task
// group, a batch's padding) are decided from the replicated failed flags,
// alike in every CTA, so every CTA takes part in every exchange; a CTA
// whose slice is empty takes part all the same. Cluster barriers remain
// at the launch's start (every CTA runs, its barriers armed, before any
// store into it) and end (no CTA leaves while another may touch it).
//
// What bounds it on an H100: not bytes or operations (one eval at N =
// 5,120 moves well under a megabyte and does ~10^8 operations per scan)
// but the latency of each of the P sequential steps: the two cluster
// exchanges (three on an eviction step), the CTA barriers between the
// passes, and the owner's commit. Section timing
// (kernels.place_scan_sections) splits a step's cycles.
//
// Hold points carried over from the JAX program. Int arm: floor division
// of possibly negative int64 (floordiv; C++ '/' truncates), arithmetic
// '>>' of negative int64, neg_inf = INT64_MIN / 4. Float arm: every
// operation rounds on its own, as PyTorch's elementwise ops do (the
// __f*_rn intrinsics, which nvcc never contracts into FMA), in the JAX
// program's order; pow(10, x) is powf, the function torch.pow calls on
// the card; spread_total sums s = 0..S-1 in index order; the max is taken
// by explicit comparisons against the same -inf the JAX program gives
// non-candidates. Both: the first index among tied winners; the ring
// counts below the offset summed over the CTAs from each one's own.

#include <cstdint>
#include <type_traits>
#include <cooperative_groups.h>
#include <cuda_runtime.h>

#include "common.cuh"

namespace cg = cooperative_groups;
using namespace nomad;

namespace {

constexpr int kThreads = 512;
constexpr int kWarps = kThreads / 32;
constexpr int kMaxCluster = 16;
// kernels.py SMEM_PER_CTA, STATIC_SMEM_RESERVE and STAT_BYTES: the plan
// lays out at most kSmemPerCta - kStaticSmemReserve bytes of dynamic
// shared memory; the launch refuses a kernel whose static shared memory
// exceeds the reserve
constexpr int kSmemPerCta = 232448;
constexpr int kStaticSmemReserve = 8192;
constexpr int kDynSmemMax = kSmemPerCta - kStaticSmemReserve;
constexpr int kStatBytes = 32;
// kernels.py SECTIONS: the parts of a step that section timing splits
constexpr int kSections = 8;
constexpr int kMaxSkip = 3;
constexpr long long kBigFp = 1LL << 44;
constexpr long long kLarge = 1LL << 40;
constexpr long long kNegInf = -(1LL << 61);  // jnp.iinfo(int64).min // 4
constexpr int kInt32Max = 2147483647;
constexpr float kF32Big = 3.40282347e+38f / 16.0f;  // finfo(f32).max / 16

// a node's flags within a step
constexpr uint8_t kFeasMask = 1;  // every mask but capacity
constexpr uint8_t kFits = 2;      // fits outright
constexpr uint8_t kMet = 4;       // the greedy meets the ask
constexpr uint8_t kFeasV = 8;     // feasible (capacity or rescue) and real
constexpr uint8_t kLow = 16;      // feasible with a score <= 0

}  // namespace

// The regions of a CTA's dynamic shared memory, in kernels.py REGIONS
// order. soff[r] >= 0: a byte offset in shared memory. Otherwise, for a
// replica: the per-CTA global arena at byte -soff[r] - 1; for a staged
// array: the tensor itself.
enum Region : int {
  kRScore, kRFlags, kRStat, kRRows, kRFailed, kRQd, kRSelOrd,  // per CTA
  kRSpreadCounts, kRSpreadEntry, kRDpCounts,   // replicas
  kRAsks, kRDesired, kRDhJob, kRDhTg, kRSpWeights, kRSpActive, kRSpTargets, kRSpDesired,
  kRDpApplies, kRDpLimit,                      // staged per task group
  kRUsed, kRJob, kRTgc, kREBase,               // staged carry
  kRTotals, kRReserved, kRFeat, kREAsk, kRSVids, kRDpVids, kRAff,  // staged per node
  kNumRegions
};

// Mirrors ScanArgs in kernels.py field for field (ints, the region
// offsets, then pointers). Every array carries the leading batch axis B;
// bool arrays are bytes. Arrays marked T hold int32 in the int arm and
// float32 in the float arm; S holds int64 and float32 respectively.
struct ScanArgs {
  int B, N, D, G, S, V, K, DP, V2, P;
  int has_reserved, has_aff, has_evict, has_forced;
  int has_pre, C, GP;  // candidate slots per node (<= 16), count groups (<= 64)
  int CS, per;         // CTAs per eval (cluster size), nodes per CTA slice
  int smem_bytes, arena_bytes;  // dynamic shared memory, global arena per CTA
  int soff[kNumRegions];
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
  // preemption (has_pre, int arm): static, carry, output
  const int32_t* pre_res;         // [B,N,C,4], 16-byte aligned
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
  // per-CTA global arena for the replicas the plan found no room for
  unsigned char* arena;           // [B * CS, arena_bytes]
  // section timing (kernels.place_scan_sections), or null: clock64
  // cycles of thread 0 of each CTA in each part of the steps
  long long* sections;            // [B * CS, kSections]
};

namespace {

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

// A candidate of the selection; fits (of its node) travels with it, so
// every CTA knows whether the winner's eviction set is committed.
template <typename Score>
struct Best {
  Score score;
  int rank;
  int idx;
  int fits;
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

// the ids the commit needs of a node: its first spreads' value ids, then
// its distinct_property value ids, kSelVids in all (any further ones are
// read from the tensors)
constexpr int kSelVids = 2;

template <typename Score>
struct Sel {
  Best<Score> best;
  int pulls;
};

// A CTA's exchanged selection partial, 32 bytes in either arm: the best
// (score bits, rank, index, fits), the pull count, and the best node's
// value ids for the commit.
struct alignas(16) SelWire {
  long long score_bits;
  int rank, idx, fits, pulls;
  int vid[kSelVids];
};
static_assert(sizeof(SelWire) == 32 && kSelVids == 2, "two 16-byte stores, in field order");

template <typename Score>
__device__ __forceinline__ SelWire to_wire(const Sel<Score>& v) {
  SelWire w;
  if constexpr (sizeof(Score) == 8) {
    w.score_bits = (long long)v.best.score;
  } else {
    w.score_bits = (long long)__float_as_int((float)v.best.score);
  }
  w.rank = v.best.rank;
  w.idx = v.best.idx;
  w.fits = v.best.fits;
  w.pulls = v.pulls;
  return w;
}

template <typename Score>
__device__ __forceinline__ Sel<Score> from_wire(const SelWire& w) {
  Sel<Score> v;
  if constexpr (sizeof(Score) == 8) {
    v.best.score = (Score)w.score_bits;
  } else {
    v.best.score = (Score)__int_as_float((int)w.score_bits);
  }
  v.best.rank = w.rank;
  v.best.idx = w.idx;
  v.best.fits = w.fits;
  v.pulls = w.pulls;
  return v;
}

// the best (BestOp, by shuffles) and pull count over the lanes of a warp,
// on every lane; over 16 lanes where lane l + 16 holds lane l's value
template <typename Score, int kLanes = 32>
__device__ __forceinline__ Sel<Score> warp_reduce_sel(Sel<Score> v) {
  static_assert(kLanes == 32 || kLanes == 16, "a warp or its mirrored halves");
  for (int o = kLanes / 2; o > 0; o >>= 1) {
    Best<Score> w;
    w.score = __shfl_xor_sync(0xffffffffu, v.best.score, o);
    w.rank = __shfl_xor_sync(0xffffffffu, v.best.rank, o);
    w.idx = __shfl_xor_sync(0xffffffffu, v.best.idx, o);
    w.fits = __shfl_xor_sync(0xffffffffu, v.best.fits, o);
    v.best = BestOp<Score>()(v.best, w);
  }
  v.pulls = __reduce_add_sync(0xffffffffu, v.pulls) / (32 / kLanes);
  return v;
}

// natural-order counts: low and feasible, and those before the ring offset
struct alignas(16) Counts {
  int low, feas, low_b, feas_b;
};

struct CountsSum {
  __device__ __forceinline__ Counts operator()(const Counts& a, const Counts& b) const {
    return {a.low + b.low, a.feas + b.feas, a.low_b + b.low_b, a.feas_b + b.feas_b};
  }
};

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
static_assert(sizeof(SpreadStat<long long>) <= kStatBytes, "stat region");
static_assert(sizeof(SpreadStat<float>) <= kStatBytes, "stat region");

// a read-only input, through the non-coherent L1 path
template <typename E>
__device__ __forceinline__ E ro(const E* p) {
  return __ldg(p);
}

__device__ __forceinline__ void cp_async4(void* dst, const void* src) {
  const unsigned s = (unsigned)__cvta_generic_to_shared(dst);
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(s), "l"(src));
}

// rows x len 4-byte words from global (row stride sstride) to shared
// memory (row stride dstride), by cp.async
__device__ void stage_words(void* dst, const void* src, int rows, int len, size_t dstride,
                            size_t sstride) {
  const int total = rows * len;
  for (int k = threadIdx.x; k < total; k += kThreads) {
    const int r = k / len, c = k - r * len;
    cp_async4(static_cast<uint32_t*>(dst) + r * dstride + c,
              static_cast<const uint32_t*>(src) + r * sstride + c);
  }
}

// rows x len elements of type E, plain copies (bytes; write-back)
template <typename E>
__device__ void copy_rows(E* dst, const E* src, int rows, int len, size_t dstride, size_t sstride) {
  const int total = rows * len;
  for (int k = threadIdx.x; k < total; k += kThreads) {
    const int r = k / len, c = k - r * len;
    dst[r * dstride + c] = src[r * sstride + c];
  }
}

// slot c of one node row (base: the row's first slot) on lane c of a
// half-warp, with its max_parallel penalty from the step's counts
__device__ __forceinline__ PreSlot load_slot(const ScanArgs& a, size_t base, int c,
                                             const int* pre_counts) {
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

template <typename T>
__global__ void __launch_bounds__(kThreads, 1) place_scan_kernel(const ScanArgs a) {
  using Score = typename Arm<T>::Score;
  using Count = typename Arm<T>::Count;
  constexpr bool kFloat = Arm<T>::kFloat;
  __shared__ Counts s_wcnt[kWarps];      // the warps' counts
  __shared__ Sel<Score> s_wsel[kWarps];  // the warps' best and pulls
  // the cluster exchange: every CTA stores its partial into every CTA's
  // slot [step parity][its rank], counted by that CTA's barrier
  __shared__ Counts s_parts[2][kMaxCluster];   // the CTAs' counts
  __shared__ SelWire s_sels[2][kMaxCluster];   // the CTAs' best and pulls
  // counts, selection, and the evicted slots' groups of an eviction step
  __shared__ __align__(8) unsigned long long s_mbar[3];
  // the chosen row's evicted slots' count groups (-1: none), from its owner
  __shared__ __align__(16) int8_t s_evict_gid[2][16];  // received, by parity
  __shared__ __align__(16) int8_t s_evict_out[16];     // the owner's, to send
  __shared__ int s_pre_counts[kGpMax];  // replica
  __shared__ int s_offset;              // replica
  __shared__ int s_nrows, s_next_row;  // the greedy's row list: length, next row
  __shared__ int s_step[2][6];  // a step's scalars, by step parity
  __shared__ long long s_sec[kSections];
  extern __shared__ __align__(16) unsigned char s_raw[];

  cg::cluster_group cluster = cg::this_cluster();
  const int CS = a.CS;
  const int crank = (int)cluster.block_rank();
  const int b = blockIdx.x / CS;
  const int tid = threadIdx.x;
  const int lane = tid & 31, warp = tid >> 5;
  const int N = a.N, D = a.D, G = a.G, S = a.S, V = a.V, K = a.K;
  const int DP = a.DP, V2 = a.V2, P = a.P, per = a.per;
  const int lo = min(crank * per, N);
  const int hi = min(lo + per, N);
  const int n_here = hi - lo;
  const size_t bN = (size_t)b * N;

  // whole-eval inputs in global memory
  // the eval's per-task-group inputs: staged in shared memory below, read
  // there (or in the tensor where the plan found no room)
  const T* asks_in = static_cast<const T*>(a.asks) + (size_t)b * G * D;
  const int32_t* desired_in = a.desired + (size_t)b * G;
  const uint8_t* dh_job_in = a.dh_job + (size_t)b * G;
  const uint8_t* dh_tg_in = a.dh_tg + (size_t)b * G;
  const T* spread_desired_in = static_cast<const T*>(a.spread_desired) + (size_t)b * G * S * V;
  const T* spread_weights_in = static_cast<const T*>(a.spread_weights) + (size_t)b * G * S;
  const uint8_t* spread_has_targets_in = a.spread_has_targets + (size_t)b * G * S;
  const uint8_t* spread_active_in = a.spread_active + (size_t)b * G * S;
  const int32_t* dp_limit_in = a.dp_limit + (size_t)b * DP;
  const uint8_t* dp_applies_in = a.dp_applies + (size_t)b * G * DP;
  const int32_t* spread_vids_g = a.spread_vids + (size_t)b * G * S * N;
  const int32_t* dp_vids_g = a.dp_vids + (size_t)b * DP * N;
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

  // -- this CTA's regions ----------------------------------------------------
  unsigned char* arena = a.arena + (size_t)blockIdx.x * a.arena_bytes;
  auto region = [&](int r) -> unsigned char* {
    const int o = a.soff[r];
    return o >= 0 ? s_raw + o : arena + (size_t)(-(long long)o - 1);
  };
  Score* s_score = reinterpret_cast<Score*>(s_raw + a.soff[kRScore]);
  uint8_t* s_flags = s_raw + a.soff[kRFlags];
  SpreadStat<Count>* s_stat = reinterpret_cast<SpreadStat<Count>*>(s_raw + a.soff[kRStat]);
  int* s_rows = reinterpret_cast<int*>(s_raw + a.soff[kRRows]);
  uint8_t* r_failed = s_raw + a.soff[kRFailed];
  long long* s_qd = reinterpret_cast<long long*>(s_raw + a.soff[kRQd]);
  int8_t* s_selord = reinterpret_cast<int8_t*>(s_raw + a.soff[kRSelOrd]);  // [per][16]
  T* r_scounts = reinterpret_cast<T*>(region(kRSpreadCounts));
  uint8_t* r_sentry = region(kRSpreadEntry);
  int32_t* r_dp = reinterpret_cast<int32_t*>(region(kRDpCounts));
  // staged per-node arrays: the slice in shared memory (row stride per),
  // or the tensor at the slice's first node (row stride N)
  auto staged = [&](int r) { return a.soff[r] >= 0; };
  auto rstride = [&](int r) { return staged(r) ? per : N; };
  auto in_smem = [&](int r, const auto* tensor) {
    using E = typename std::remove_cv<typename std::remove_pointer<decltype(tensor)>::type>::type;
    return staged(r) ? reinterpret_cast<const E*>(s_raw + a.soff[r]) : tensor;
  };
  const T* asks = in_smem(kRAsks, asks_in);
  const int32_t* desired = in_smem(kRDesired, desired_in);
  const uint8_t* dh_job = in_smem(kRDhJob, dh_job_in);
  const uint8_t* dh_tg = in_smem(kRDhTg, dh_tg_in);
  const T* spread_weights = in_smem(kRSpWeights, spread_weights_in);
  const uint8_t* spread_active = in_smem(kRSpActive, spread_active_in);
  const uint8_t* spread_has_targets = in_smem(kRSpTargets, spread_has_targets_in);
  const T* spread_desired = in_smem(kRSpDesired, spread_desired_in);
  const uint8_t* dp_applies = in_smem(kRDpApplies, dp_applies_in);
  const int32_t* dp_limit = in_smem(kRDpLimit, dp_limit_in);
  T* used = staged(kRUsed) ? reinterpret_cast<T*>(s_raw + a.soff[kRUsed])
                           : static_cast<T*>(a.used) + (bN + lo) * D;
  int32_t* jobc = staged(kRJob) ? reinterpret_cast<int32_t*>(s_raw + a.soff[kRJob])
                                : a.job_counts + bN + lo;
  int32_t* tgc = staged(kRTgc) ? reinterpret_cast<int32_t*>(s_raw + a.soff[kRTgc])
                               : a.tg_counts + (size_t)b * G * N + lo;
  int32_t* ebase = kFloat ? nullptr
                          : (staged(kREBase) ? reinterpret_cast<int32_t*>(s_raw + a.soff[kREBase])
                                             : a.e_base + (bN + lo) * 2);
  const T* totals = staged(kRTotals) ? reinterpret_cast<const T*>(s_raw + a.soff[kRTotals])
                                     : static_cast<const T*>(a.totals) + (bN + lo) * D;
  const T* reserved =
      !a.has_reserved ? nullptr
                      : (staged(kRReserved) ? reinterpret_cast<const T*>(s_raw + a.soff[kRReserved])
                                            : static_cast<const T*>(a.reserved) + (bN + lo) * D);
  const uint8_t* feat = staged(kRFeat) ? s_raw + a.soff[kRFeat] : a.feat + (size_t)b * G * N + lo;
  const int32_t* eask =
      kFloat ? nullptr
             : (staged(kREAsk) ? reinterpret_cast<const int32_t*>(s_raw + a.soff[kREAsk])
                               : a.e_ask + ((size_t)b * G * N + lo) * 2);
  const int32_t* svids = staged(kRSVids) ? reinterpret_cast<const int32_t*>(s_raw + a.soff[kRSVids])
                                         : spread_vids_g + lo;
  const int32_t* dpv = staged(kRDpVids) ? reinterpret_cast<const int32_t*>(s_raw + a.soff[kRDpVids])
                                        : dp_vids_g + lo;
  const T* aff = !a.has_aff ? nullptr
                            : (staged(kRAff) ? reinterpret_cast<const T*>(s_raw + a.soff[kRAff])
                                             : static_cast<const T*>(a.aff_score) + (size_t)b * G * N + lo);
  const int rs_tgc = rstride(kRTgc), rs_feat = rstride(kRFeat), rs_eask = rstride(kREAsk);
  const int rs_sv = rstride(kRSVids), rs_dp = rstride(kRDpVids), rs_aff = rstride(kRAff);

  // -- stage the task groups' inputs, the slice and the replicas, once ----
  auto stage = [&](int r, const void* src, int words) {
    if (staged(r)) stage_words(s_raw + a.soff[r], src, 1, words, 0, 0);
  };
  auto stage_bytes = [&](int r, const uint8_t* src, int n) {
    if (staged(r)) copy_rows(s_raw + a.soff[r], src, 1, n, 0, 0);
  };
  stage(kRAsks, asks_in, G * D);
  stage(kRDesired, desired_in, G);
  stage(kRSpWeights, spread_weights_in, G * S);
  stage(kRSpDesired, spread_desired_in, G * S * V);
  stage(kRDpLimit, dp_limit_in, DP);
  stage_bytes(kRDhJob, dh_job_in, G);
  stage_bytes(kRDhTg, dh_tg_in, G);
  stage_bytes(kRSpActive, spread_active_in, G * S);
  stage_bytes(kRSpTargets, spread_has_targets_in, G * S);
  stage_bytes(kRDpApplies, dp_applies_in, G * DP);
  if (staged(kRUsed)) stage_words(used, static_cast<const T*>(a.used) + (bN + lo) * D, 1, n_here * D, 0, 0);
  if (staged(kRJob)) stage_words(jobc, a.job_counts + bN + lo, 1, n_here, 0, 0);
  if (staged(kRTgc)) stage_words(tgc, a.tg_counts + (size_t)b * G * N + lo, G, n_here, per, N);
  if (!kFloat && staged(kREBase)) stage_words(ebase, a.e_base + (bN + lo) * 2, 1, n_here * 2, 0, 0);
  if (staged(kRTotals))
    stage_words(s_raw + a.soff[kRTotals], static_cast<const T*>(a.totals) + (bN + lo) * D, 1, n_here * D, 0, 0);
  if (a.has_reserved && staged(kRReserved))
    stage_words(s_raw + a.soff[kRReserved], static_cast<const T*>(a.reserved) + (bN + lo) * D, 1,
                n_here * D, 0, 0);
  if (!kFloat && staged(kREAsk))
    stage_words(s_raw + a.soff[kREAsk], a.e_ask + ((size_t)b * G * N + lo) * 2, G, n_here * 2,
                (size_t)per * 2, (size_t)N * 2);
  if (staged(kRSVids)) stage_words(s_raw + a.soff[kRSVids], spread_vids_g + lo, G * S, n_here, per, N);
  if (staged(kRDpVids)) stage_words(s_raw + a.soff[kRDpVids], dp_vids_g + lo, DP, n_here, per, N);
  if (a.has_aff && staged(kRAff))
    stage_words(s_raw + a.soff[kRAff], static_cast<const T*>(a.aff_score) + (size_t)b * G * N + lo, G,
                n_here, per, N);
  if (staged(kRFeat)) copy_rows(s_raw + a.soff[kRFeat], a.feat + (size_t)b * G * N + lo, G, n_here, per, N);
  copy_rows(r_scounts, static_cast<const T*>(a.spread_counts) + (size_t)b * G * S * V, 1, G * S * V, 0, 0);
  copy_rows(r_sentry, a.spread_entry + (size_t)b * G * S * V, 1, G * S * V, 0, 0);
  copy_rows(r_dp, a.dp_counts + (size_t)b * DP * V2, 1, DP * V2, 0, 0);
  copy_rows(r_failed, a.failed + (size_t)b * G, 1, G, 0, 0);
  const bool has_pre = !kFloat && a.has_pre;
  if (has_pre) copy_rows(s_pre_counts, a.pre_counts + (size_t)b * a.GP, 1, a.GP, 0, 0);
  if (tid == 0) s_offset = a.offset[b];
  // the Q45 reciprocal of each task group's desired count (anti-affinity)
  for (int k = tid; k < G; k += kThreads)
    s_qd[k] = (1LL << kRecipBits) / (desired_in[k] > 1 ? desired_in[k] : 1);
  if (tid == 0) {
    // each exchange barrier completes a phase a step: its one arrival (armed
    // with the bytes the CS partials bring) and their bytes
    for (int k = 0; k < 3; ++k) mbar_init(&s_mbar[k]);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
    mbar_arm(&s_mbar[0], CS * (int)sizeof(Counts));
    mbar_arm(&s_mbar[1], CS * (int)sizeof(SelWire));
    mbar_arm(&s_mbar[2], 16);  // one sender: the chosen node's owner
  }
  asm volatile("cp.async.commit_group;\n" ::);
  asm volatile("cp.async.wait_all;\n" ::);
  // every CTA of the cluster runs, its barriers armed, before any stores
  // into its shared memory
  cluster.sync();

  const int n_real = a.n_real[b];
  const int nr = n_real > 1 ? n_real : 1;
  const int invalid_bucket = V - 1;
  const int C = a.C;
  // each thread owns a contiguous run of the slice
  const int run = (per + kThreads - 1) / kThreads;
  const int l0 = min(tid * run, n_here);
  const int l1 = min(l0 + run, n_here);
  int par = 0;   // the step parity: the exchange's slots
  int par3 = 0;  // the parity of the eviction steps' exchange
  // section timing: thread 0 adds the cycles since its last mark to s_sec[k]
  const bool timing = a.sections != nullptr && tid == 0;
  long long t_mark = 0;
  if (timing) {
    for (int k = 0; k < kSections; ++k) s_sec[k] = 0;
    t_mark = clock64();
  }
  // the per-placement scalars of a step: g, limit, evicted node and task
  // group, forced node, spread weight sum. Each cluster barrier's acquire
  // leaves no global line in L1, so a load after one waits on L2; a step
  // that ran copies the next step's into s_step[next parity] by cp.async
  // (lanes of the last warp, after the scan's CTA barrier, waited on before
  // the step ends), and the step after a skipped one loads its own.
  bool prefetched = false;
  auto mark = [&](int k) {
    if (timing) {
      const long long t = clock64();
      s_sec[k] += t - t_mark;
      t_mark = t;
    }
  };

  for (int p = 0; p < P; ++p) {
    int in[6];
    if (prefetched) {
      for (int k = 0; k < 6; ++k) in[k] = s_step[p & 1][k];
    } else {
      in[0] = ro(tg_idx + p);
      in[1] = ro(limit_p + p);
      in[2] = ro(evict_node + p);
      in[3] = ro(evict_tg + p);
      in[4] = a.has_forced ? ro(forced_node + p) : -1;
      in[5] = ro(reinterpret_cast<const int32_t*>(sum_sw_p) + p);  // its 4 bytes
    }
    T in_sum_sw;
    if constexpr (kFloat) {
      in_sum_sw = __int_as_float(in[5]);
    } else {
      in_sum_sw = in[5];
    }
    const int g = in[0];
    if (r_failed[g]) {
      // a step of a failed task group (or a batch's padding) changes
      // nothing of the carry: write its outputs and move on (every CTA
      // decides alike from its replica)
      if (crank == 0 && tid == 0) {
        a.chosen[bP + p] = -1;
        scores[p] = (Score)0;
        a.pulls[bP + p] = 0;
        a.skipped[bP + p] = 1;
      }
      mark(0);
      prefetched = false;
      continue;
    }
    const int offset = s_offset;
    const int limit = in[1];

    // -- eviction of the previous alloc (engine.py:291-332) ----------------
    const int ev_node_raw = in[2];
    const int ev_tg_raw = in[3];
    const bool do_evict = a.has_evict && ev_node_raw >= 0;
    const int ev_node = ev_node_raw > 0 ? ev_node_raw : 0;
    const int ev_tg = ev_tg_raw > 0 ? ev_tg_raw : 0;
    const bool dec_tg = do_evict && ev_tg_raw >= 0;
    const bool ev_own = ev_node >= lo && ev_node < hi;
    if (tid == 0) {
      if (has_pre) s_nrows = s_next_row = 0;
      if (do_evict) {
        if (ev_own) {
          const int li = ev_node - lo;
          for (int d = 0; d < D; ++d) used[li * D + d] = sub_t(used[li * D + d], ro(evict_res + p * D + d));
          jobc[li] -= 1;
          if (dec_tg) tgc[ev_tg * rs_tgc + li] -= 1;
          if constexpr (!kFloat) {
            for (int d = 0; d < 2; ++d)
              ebase[li * 2 + d] = (int32_t)(((long long)ebase[li * 2 + d] * ro(ev_factor + p * 2 + d)) >> kE27Bits);
          }
        }
        if (dec_tg) {
          for (int s = 0; s < S; ++s) {
            if (!spread_active[ev_tg * S + s]) continue;
            const int vid = ro(spread_vids_g + ((size_t)ev_tg * S + s) * N + ev_node);
            if (vid >= 0 && vid < V) {
              T& c = r_scounts[((size_t)ev_tg * S + s) * V + vid];
              c = sub_t(c, (T)1);
            }
          }
        }
      }
    }
    // (thread 0 changed nothing that others read unless it evicted or
    // reset the row list)
    if (do_evict || has_pre) __syncthreads();
    mark(0);

    // -- per-spread entry statistics (engine.py:469, :522-532, :601-605) ----
    // only an active spread without targets reads them
    bool need_stats = false;
    for (int s = 0; s < S; ++s)
      need_stats = need_stats || (spread_active[g * S + s] && !spread_has_targets[g * S + s]);
    for (int s = warp; need_stats && s < S; s += kWarps) {
      const size_t row = ((size_t)g * S + s) * V;
      Entries<Count> e;
      if constexpr (kFloat) {
        e = {INFINITY, -INFINITY, 0};
      } else {
        e = {kLarge, -kLarge, 0};
      }
      for (int v = lane; v < invalid_bucket; v += 32) {
        if (r_sentry[row + v]) {
          const Count c = r_scounts[row + v] > 0 ? (Count)r_scounts[row + v] : (Count)0;
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
        s_stat[s] = st;
      }
    }
    if (need_stats) __syncthreads();
    mark(1);

    // -- pass 1: feasibility and score of every node of the slice ----------
    const bool dh_job_g = dh_job[g] != 0;
    const bool dh_tg_g = dh_tg[g] != 0;
    const long long q_d = s_qd[g];
    const float desired_f = (float)desired[g];
    const int fnode = in[4];
    long long ask3[3] = {0, 0, 0};
    if (has_pre)
      for (int d = 0; d < 3; ++d) ask3[d] = (long long)asks[g * D + d];
    for (int li = l0; li < l1; ++li) {
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
      const int tgc_i = tgc[g * rs_tgc + li];
      const int jc = jobc[li];
      const bool dh = dh_job_g ? (jc == 0) : (dh_tg_g ? !(tgc_i > 0 && jc > 0) : true);
      const uint8_t fbits = feat[g * rs_feat + li];
      // every mask but capacity (the AND is order-free)
      bool feasible = (fbits & 1) && dh;
      if (a.has_forced) feasible = feasible && (fnode < 0 || i == fnode);
      for (int d = 0; d < DP; ++d) {
        const int vid = dpv[d * rs_dp + li];
        int c = 0;
        if (vid >= 0 && vid < V2) c = r_dp[d * V2 + vid] > 0 ? r_dp[d * V2 + vid] : 0;
        const bool applies = dp_applies[g * DP + d] != 0;
        const bool missing = vid == V2 - 1;
        feasible = feasible && (!applies || (!missing && c < dp_limit[d]));
      }
      bool pmask = false;
      for (int k = 0; k < K; ++k) pmask = pmask || ro(penalty_idx + p * K + k) == i;
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
        const float affv = aff_p ? aff[g * rs_aff + li] : 0.f;

        float spread_total = 0.f;
        for (int s = 0; s < S; ++s) {
          float per_s = 0.f;
          if (spread_active[g * S + s]) {
            const size_t row = ((size_t)g * S + s);
            const int vid = svids[row * rs_sv + li];
            const bool inr = vid >= 0 && vid < V;
            float cur = 0.f, dd = 0.f;
            if (inr) {
              cur = r_scounts[row * V + vid] > 0.f ? r_scounts[row * V + vid] : 0.f;
              dd = spread_desired[row * V + vid];
            }
            if (vid == invalid_bucket) {
              per_s = -1.f;
            } else if (spread_has_targets[g * S + s]) {
              if (dd > 0.f) {
                const float wf = __fdiv_rn(spread_weights[g * S + s], max_keep_nan(in_sum_sw, kEps));
                per_s = __fmul_rn(__fdiv_rn(__fsub_rn(dd, __fadd_rn(cur, 1.f)), dd), wf);
              } else {
                per_s = dd == 0.f ? -kF32Big : -1.f;
              }
            } else {
              const SpreadStat<Count> st = s_stat[s];
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
        const int32_t* ea = eask + (size_t)g * rs_eask * 2;
        const long long binpack = binpack_q30(e_sel(ebase, ea, li, 0), e_sel(ebase, ea, li, 1));
        const long long anti = anti_q30(anti_present, tgc_i, q_d);
        const long long resched = pmask ? -kTermOne : 0;
        const long long affv = aff_p ? (long long)aff[g * rs_aff + li] : 0;

        long long spread_total = 0;
        for (int s = 0; s < S; ++s) {
          if (!spread_active[g * S + s]) continue;
          const size_t row = ((size_t)g * S + s);
          const int vid = svids[row * rs_sv + li];
          const bool inr = vid >= 0 && vid < V;
          long long cur = 0, dd = 0;
          if (inr) {
            cur = r_scounts[row * V + vid] > 0 ? r_scounts[row * V + vid] : 0;
            dd = spread_desired[row * V + vid];
          }
          long long per_s;
          if (vid == invalid_bucket) {
            per_s = -kTermOne;
          } else if (spread_has_targets[g * S + s]) {
            if (dd > 0) {
              const long long t_num = (dd - 100 * (cur + 1)) * (long long)spread_weights[g * S + s] * kTermOne;
              per_s = floordiv_pos(t_num, dd * sw64);
            } else {
              per_s = dd == 0 ? -kBigFp : -kTermOne;
            }
          } else {
            const SpreadStat<Count> st = s_stat[s];
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
      s_score[li] = final_score;
      s_flags[li] = (uint8_t)((feasible ? kFeasMask : 0) | (fits ? kFits : 0));
      // preemption rescue, cap_ok = fits | met, only where it can decide
      if (has_pre && feasible && !fits && i < n_real) s_rows[atomicAdd(&s_nrows, 1)] = li;
    }

    if constexpr (!kFloat) {
      if (has_pre) {
        // the greedy over the row list, a row a half-warp (the next row
        // free when it is: rows differ in rounds), a slot a lane
        __syncthreads();
        const int c = tid & 15;
        const unsigned hmask = 0xffffu << (tid & 16);
        const int nrows = s_nrows;
        for (;;) {
          const int k = __shfl_sync(hmask, c == 0 ? atomicAdd(&s_next_row, 1) : 0, 0, 16);
          if (k >= nrows) break;
          const int li = s_rows[k];
          const size_t node = bN + lo + li;
          const PreSlot slot = load_slot(a, node * C, c, s_pre_counts);
          const long long rem[3] = {a.pre_remaining[node * 3 + 0], a.pre_remaining[node * 3 + 1],
                                    a.pre_remaining[node * 3 + 2]};
          int sel;
          const bool met = greedy_half(ask3, rem, slot, C, hmask, &sel);
          if (met && c == 0) s_flags[li] |= kMet;
          s_selord[li * 16 + c] = (int8_t)sel;  // the commit's, if chosen
        }
        __syncthreads();
      }
    }

    mark(2);

    // -- the slice's counts, published; cluster barrier 1 ------------------
    Counts cnt = {0, 0, 0, 0};
    for (int li = l0; li < l1; ++li) {
      const int i = lo + li;
      const uint8_t f = s_flags[li];
      const bool feas_v = (f & kFeasMask) && (f & (kFits | kMet)) && i < n_real;
      const bool low = feas_v && s_score[li] <= (Score)0;
      s_flags[li] = (uint8_t)(f | (feas_v ? kFeasV : 0) | (low ? kLow : 0));
      cnt.low += low;
      cnt.feas += feas_v;
      if (i < offset) {
        cnt.low_b += low;
        cnt.feas_b += feas_v;
      }
    }
    // the block's scan of (low, feasible) and totals of all four counts:
    // a warp's counts fit 16 bits (32 runs of at most ~50 nodes), so two
    // ride one word through the shuffles
    Counts excl = {0, 0, 0, 0}, agg = {0, 0, 0, 0};
    {
      const unsigned own = (unsigned)cnt.low | ((unsigned)cnt.feas << 16);
      unsigned inc = own;
      for (int o = 1; o < 32; o <<= 1) {
        const unsigned up = __shfl_up_sync(0xffffffffu, inc, o);
        if (lane >= o) inc += up;
      }
      const unsigned bef =
          __reduce_add_sync(0xffffffffu, (unsigned)cnt.low_b | ((unsigned)cnt.feas_b << 16));
      if (lane == 31)
        s_wcnt[warp] = {(int)(inc & 0xffffu), (int)(inc >> 16), (int)(bef & 0xffffu), (int)(bef >> 16)};
      __syncthreads();
      for (int w = 0; w < kWarps; ++w) {
        const Counts v = s_wcnt[w];
        agg = CountsSum()(agg, v);
        if (w < warp) excl = CountsSum()(excl, v);
      }
      const unsigned ex = inc - own;
      excl.low += (int)(ex & 0xffffu);
      excl.feas += (int)(ex >> 16);
    }
    // the next step's scalars (no thread reads that parity's slots after
    // the barrier above until the step ends)
    const bool fetcher = warp == kWarps - 1 && lane < 6 && p + 1 < P;
    if (fetcher) {
      const void* src = lane == 0 ? (const void*)tg_idx : lane == 1 ? (const void*)limit_p
                      : lane == 2 ? (const void*)evict_node : lane == 3 ? (const void*)evict_tg
                      : lane == 4 ? (const void*)forced_node : (const void*)sum_sw_p;
      if (lane != 4 || a.has_forced) {
        cp_async4(&s_step[(p + 1) & 1][lane], static_cast<const int32_t*>(src) + p + 1);
        asm volatile("cp.async.commit_group;\n" ::);
      } else {
        s_step[(p + 1) & 1][4] = -1;
      }
    }
    mark(3);
    // exchange 1: lane r of warp 0 stores the slice's counts into CTA r
    if (warp == 0 && lane < CS)
      st_async16(&s_parts[par][crank], lane, &s_mbar[0],
                 make_uint4(agg.low, agg.feas, agg.low_b, agg.feas_b));
    mbar_wait(&s_mbar[0], par);
    if (tid == 0) mbar_arm(&s_mbar[0], CS * (int)sizeof(Counts));  // the next step's phase
    // every thread: the totals, and the lower-rank CTAs' counts, in rank order
    Counts tot = {0, 0, 0, 0}, pfx = {0, 0, 0, 0};
    for (int r = 0; r < CS; ++r) {
      const Counts v = s_parts[par][r];
      tot = CountsSum()(tot, v);
      if (r < crank) pfx = CountsSum()(pfx, v);
    }
    mark(4);
    const int ret_total = tot.feas - (tot.low < kMaxSkip ? tot.low : kMaxSkip);
    const int backlog_n = limit - ret_total > 0 ? limit - ret_total : 0;

    // -- pass 2: ring cumsums, limit window, selection (engine.py:660-723) --
    Sel<Score> sel = {{Arm<T>::neg_inf(), kInt32Max, kInt32Max, 0}, 0};
    {
      // natural-order inclusive counts: lower-rank CTAs, lower threads, the run
      int nat_low = pfx.low + excl.low;
      int nat_feas = pfx.feas + excl.feas;
      for (int li = l0; li < l1; ++li) {
        const int i = lo + li;
        const uint8_t f = s_flags[li];
        const int low = (f & kLow) ? 1 : 0;
        const int fv = (f & kFeasV) ? 1 : 0;
        nat_low += low;
        nat_feas += fv;
        const int low_cum = i >= offset ? nat_low - tot.low_b : nat_low + tot.low - tot.low_b;
        const int feas_cum = i >= offset ? nat_feas - tot.feas_b : nat_feas + tot.feas - tot.feas_b;
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
          sel.best = BestOp<Score>()(sel.best, Best<Score>{s_score[li], rank, i, (f & kFits) ? 1 : 0});
        }
        sel.pulls += pulled;
      }
    }
    // the slice's best and pulls: each warp's by shuffles, then warp 0's
    // lanes over the warps'
    {
      const Sel<Score> v = warp_reduce_sel(sel);
      if (lane == 0) s_wsel[warp] = v;
    }
    __syncthreads();
    mark(5);
    // exchange 2: lane r of warp 0 stores the slice's best and pulls into
    // CTA r; every thread reduces the CTAs' partials to the same winner
    if (warp == 0) {
      static_assert(kWarps == 16, "the warps' partials fill half a warp");
      const Sel<Score> v = warp_reduce_sel<Score, 16>(s_wsel[lane & 15]);
      // with the best node's value ids for the commit (the spreads', then
      // the distinct_property ones), from this CTA's slice
      int id = 0;
      const int li = v.best.idx - lo;
      if (lane < kSelVids && li >= 0 && li < n_here) {
        if (lane < S) id = svids[((size_t)g * S + lane) * rs_sv + li];
        else if (lane - S < DP) id = dpv[(lane - S) * rs_dp + li];
      }
      const SelWire w = to_wire(v);
      const int id0 = __shfl_sync(0xffffffffu, id, 0), id1 = __shfl_sync(0xffffffffu, id, 1);
      if (lane < CS) {
        const char* slot = reinterpret_cast<const char*>(&s_sels[par][crank]);
        st_async16(slot, lane, &s_mbar[1],
                   make_uint4((unsigned)w.score_bits, (unsigned)(w.score_bits >> 32), w.rank, w.idx));
        st_async16(slot + 16, lane, &s_mbar[1], make_uint4(w.fits, w.pulls, id0, id1));
      }
    }
    mbar_wait(&s_mbar[1], par);
    if (tid == 0) mbar_arm(&s_mbar[1], CS * (int)sizeof(SelWire));
    const Sel<Score> win = warp_reduce_sel<Score, 16>(
        (lane & 15) < CS ? from_wire<Score>(s_sels[par][lane & 15])
                         : Sel<Score>{{Arm<T>::neg_inf(), kInt32Max, kInt32Max, 0}, 0});
    mark(6);

    // -- outputs and the carry update (engine.py:716-857) ------------------
    const int chosen = win.best.idx != kInt32Max ? win.best.idx : -1;
    const bool success = chosen >= 0;
    const bool ch_own = success && chosen >= lo && chosen < hi;
    // the chosen node's value ids, from its owner's partial
    const int* ch_vid = success ? s_sels[par][chosen / per].vid : nullptr;
    if (tid == 0) {
      if (crank == 0) {
        a.chosen[bP + p] = chosen;
        scores[p] = success ? win.best.score : (Score)0;
        a.pulls[bP + p] = win.pulls;
        a.skipped[bP + p] = 0;
      }
      s_offset = (offset + win.pulls) % nr;
      if (success) {
        const int ch = chosen;
        if (ch_own) {
          const int li = ch - lo;
          for (int d = 0; d < D; ++d) used[li * D + d] = add_t(used[li * D + d], asks[g * D + d]);
          tgc[g * rs_tgc + li] += 1;
          jobc[li] += 1;
          if constexpr (!kFloat) {
            const int32_t* ea = eask + (size_t)g * rs_eask * 2;
            const long long e0 = e_sel(ebase, ea, li, 0);
            const long long e1 = e_sel(ebase, ea, li, 1);
            ebase[li * 2 + 0] = (int32_t)e0;
            ebase[li * 2 + 1] = (int32_t)e1;
          }
        }
        for (int s = 0; s < S; ++s) {
          if (!spread_active[g * S + s]) continue;
          const size_t row = (size_t)g * S + s;
          const int vid = s < kSelVids ? ch_vid[s] : ro(spread_vids_g + row * N + ch);
          if (vid >= 0 && vid < V) {
            r_scounts[row * V + vid] = add_t(r_scounts[row * V + vid], (T)1);
            r_sentry[row * V + vid] = 1;
          }
        }
        for (int d = 0; d < DP; ++d) {
          if (!dp_applies[g * DP + d]) continue;
          const int vid = S + d < kSelVids ? ch_vid[S + d] : ro(dp_vids_g + (size_t)d * N + ch);
          if (vid >= 0 && vid < V2) r_dp[d * V2 + vid] += 1;
        }
      }
      if (do_evict && !success) {  // revert the eviction
        if (ev_own) {
          const int li = ev_node - lo;
          for (int d = 0; d < D; ++d) used[li * D + d] = add_t(used[li * D + d], ro(evict_res + p * D + d));
          jobc[li] += 1;
          if (dec_tg) tgc[ev_tg * rs_tgc + li] += 1;
          if constexpr (!kFloat) {
            for (int d = 0; d < 2; ++d)
              ebase[li * 2 + d] = (int32_t)(((long long)ebase[li * 2 + d] * ro(rev_factor + p * 2 + d)) >> kE27Bits);
          }
        }
        if (dec_tg) {
          for (int s = 0; s < S; ++s) {
            if (!spread_active[ev_tg * S + s]) continue;
            const int vid = ro(spread_vids_g + ((size_t)ev_tg * S + s) * N + ev_node);
            if (vid >= 0 && vid < V) {
              T& c = r_scounts[((size_t)ev_tg * S + s) * V + vid];
              c = add_t(c, (T)1);
            }
          }
        }
      }
      const bool unforced = !a.has_forced || fnode < 0;
      if (!success && unforced) r_failed[g] = 1;
    }
    if constexpr (!kFloat) {
      // commit the eviction set where the chosen node did not fit outright
      // (engine.py:761-832): the owner's half-warp, then barrier 3
      if (has_pre && success && !win.best.fits) {
        const int ch = chosen;
        const size_t base = (bN + ch) * C;
        if (ch_own && tid < 16) {
          // the owner's half-warp, a slot a lane: the second pass over the
          // greedy order pass 1 kept, then the carry of the chosen node
          const int li = ch - lo;
          const PreSlot slot = load_slot(a, base, tid, s_pre_counts);
          long long* rem_p = a.pre_remaining + (bN + ch) * 3;
          const long long rem[3] = {rem_p[0], rem_p[1], rem_p[2]};
          int rank;
          const bool keep = second_pass_half(ask3, rem, slot, s_selord[li * 16 + tid], 0xffffu, &rank);
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
          s_evict_out[tid] = (int8_t)(keep && gid >= 0 && gid < a.GP ? gid : -1);
          // the freed capacity credits used after the score terms (dims past
          // 4 free nothing); the Q27 product runs over the kept slots in slot
          // order (not associative)
          long long freed[4];
          for (int d = 0; d < 3; ++d) freed[d] = half_sum(keep ? slot.res[d] : 0, 0xffffu);
          freed[3] = half_sum(keep ? res4 : 0, 0xffffu);
          long long eb[2] = {(long long)ebase[li * 2 + 0], (long long)ebase[li * 2 + 1]};
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
            for (int d = 0; d < 4; ++d) used[li * D + d] -= (int32_t)freed[d];
            ebase[li * 2 + 0] = (int32_t)eb[0];
            ebase[li * 2 + 1] = (int32_t)eb[1];
            for (int d = 0; d < 3; ++d) rem_p[d] += freed[d];
          }
          // the evicted slots' groups to every CTA
          if (tid < CS)
            st_async16(&s_evict_gid[par3][0], tid, &s_mbar[2], *reinterpret_cast<const uint4*>(s_evict_out));
        }
        mbar_wait(&s_mbar[2], par3);
        if (tid == 0) {
          mbar_arm(&s_mbar[2], 16);
          for (int c = 0; c < 16; ++c) {
            const int gid = s_evict_gid[par3][c];
            if (gid >= 0) s_pre_counts[gid] += 1;
          }
        }
        par3 ^= 1;
      }
    }
    if (fetcher) asm volatile("cp.async.wait_all;\n" ::);
    __syncthreads();
    mark(7);
    par ^= 1;
    prefetched = p + 1 < P;
  }
  if (timing)
    for (int k = 0; k < kSections; ++k) a.sections[(size_t)blockIdx.x * kSections + k] = s_sec[k];

  // no CTA leaves while another may still read its shared memory
  cluster.sync();
  // write back the carried slice; rank 0 writes back the replicas
  if (staged(kRUsed)) copy_rows(static_cast<T*>(a.used) + (bN + lo) * D, used, 1, n_here * D, 0, 0);
  if (staged(kRJob)) copy_rows(a.job_counts + bN + lo, jobc, 1, n_here, 0, 0);
  if (staged(kRTgc)) copy_rows(a.tg_counts + (size_t)b * G * N + lo, tgc, G, n_here, N, per);
  if (!kFloat && staged(kREBase)) copy_rows(a.e_base + (bN + lo) * 2, ebase, 1, n_here * 2, 0, 0);
  if (crank == 0) {
    copy_rows(static_cast<T*>(a.spread_counts) + (size_t)b * G * S * V, r_scounts, 1, G * S * V, 0, 0);
    copy_rows(a.spread_entry + (size_t)b * G * S * V, r_sentry, 1, G * S * V, 0, 0);
    copy_rows(a.dp_counts + (size_t)b * DP * V2, r_dp, 1, DP * V2, 0, 0);
    copy_rows(a.failed + (size_t)b * G, r_failed, 1, G, 0, 0);
    if (has_pre) copy_rows(a.pre_counts + (size_t)b * a.GP, s_pre_counts, 1, a.GP, 0, 0);
    if (tid == 0) a.offset[b] = s_offset;
  }
}

// Opt in to the plan's dynamic shared memory and to clusters of 16; the
// static shared memory must stay inside the plan's reserve.
template <typename T>
cudaError_t configure() {
  cudaFuncAttributes fa;
  cudaError_t e = cudaFuncGetAttributes(&fa, place_scan_kernel<T>);
  if (e != cudaSuccess) return e;
  if (fa.sharedSizeBytes > (size_t)kStaticSmemReserve) return cudaErrorInvalidConfiguration;
  e = cudaFuncSetAttribute(place_scan_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize,
                           kDynSmemMax);
  if (e != cudaSuccess) return e;
  return cudaFuncSetAttribute(place_scan_kernel<T>, cudaFuncAttributeNonPortableClusterSizeAllowed, 1);
}

template <typename T>
int launch(const ScanArgs* args, void* stream) {
  if (args->B == 0 || args->P == 0) return 0;
  const int cs = args->CS;
  if (args->has_pre && (args->C > kCMax || args->GP > kGpMax)) return (int)cudaErrorInvalidValue;
  if (cs < 1 || cs > kMaxCluster || (cs & (cs - 1)) || (long long)args->per * cs < args->N ||
      args->smem_bytes < 0 || args->smem_bytes > kDynSmemMax)
    return (int)cudaErrorInvalidValue;
  cudaError_t e = configure<T>();
  if (e != cudaSuccess) return (int)e;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(args->B * cs);
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
  e = cudaLaunchKernelEx(&cfg, place_scan_kernel<T>, *args);
  if (e != cudaSuccess) return (int)e;
  return (int)cudaGetLastError();
}

template <typename T>
int max_clusters(int cs, int smem_bytes) {
  if (configure<T>() != cudaSuccess) return -1;
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
  if (cudaOccupancyMaxActiveClusters(&n, place_scan_kernel<T>, &cfg) != cudaSuccess) {
    cudaGetLastError();  // a refused size reads as no cluster, not a sticky error
    return 0;
  }
  return n;
}

// Test entry of the scan's exact integer helpers: isqrt64 and coord_q
// (K8) and floordiv_pos (the targeted spread), elementwise, for holding
// them against isqrt_t / coord_q_t / torch's floor division on the card
__global__ void k8_sweep_kernel(const long long* n, long long* isq, int count,
                                const long long* needed, const long long* res, long long* cq,
                                int count_cq, const long long* num, const long long* den,
                                long long* fq, int count_fd) {
  for (int k = blockIdx.x * blockDim.x + threadIdx.x; k < count || k < count_cq || k < count_fd;
       k += gridDim.x * blockDim.x) {
    if (k < count) isq[k] = isqrt64(n[k]);
    if (k < count_cq) cq[k] = coord_q(needed[k], res[k]);
    if (k < count_fd) fq[k] = floordiv_pos(num[k], den[k]);
  }
}

}  // namespace

extern "C" int place_scan_launch(const ScanArgs* args, void* stream) {
  return launch<int32_t>(args, stream);
}

extern "C" int place_scan_f32_launch(const ScanArgs* args, void* stream) {
  return launch<float>(args, stream);
}

// cudaOccupancyMaxActiveClusters of the arm's kernel at this cluster size
// and dynamic shared memory: 0 where the card cannot co-schedule it
extern "C" int place_scan_max_clusters(int cs, int smem_bytes, int float_arm) {
  return float_arm ? max_clusters<float>(cs, smem_bytes) : max_clusters<int32_t>(cs, smem_bytes);
}

extern "C" int k8_sweep_launch(const long long* n, long long* isq, int count, const long long* needed,
                               const long long* res, long long* cq, int count_cq,
                               const long long* num, const long long* den, long long* fq,
                               int count_fd, void* stream) {
  int total = count > count_cq ? count : count_cq;
  total = total > count_fd ? total : count_fd;
  if (total == 0) return 0;
  const int blocks = (total + 255) / 256 < 1024 ? (total + 255) / 256 : 1024;
  k8_sweep_kernel<<<blocks, 256, 0, (cudaStream_t)stream>>>(n, isq, count, needed, res, cq,
                                                            count_cq, num, den, fq, count_fd);
  return (int)cudaGetLastError();
}

extern "C" const char* place_scan_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}

extern "C" int place_scan_args_size() { return (int)sizeof(ScanArgs); }
