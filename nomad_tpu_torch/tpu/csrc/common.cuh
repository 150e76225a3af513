// Arithmetic shared by the placement scan (place_scan.cu) and the
// forced-node kernel (forced_eval.cu): the Q-format constants of the int
// spec (nomad_tpu/tpu/intscore.py), the score terms both kernels compute
// for a node, and the exact integer helpers of device-side preemption
// (nomad_tpu/tpu/preempt.py), the greedy and the second pass as half-warp
// functions. One definition keeps the two kernels bit for bit equal on
// the same input, in both arms.
//
// Int arm hold points: floor division of possibly negative int64
// (floordiv; C++ '/' truncates), arithmetic '>>' of negative int64, an
// exact integer square root and Q16 quotient (from double precision,
// each with a complete integer fix-up). Float arm: every operation rounds
// on its own (__f*_rn, which nvcc never contracts into FMA), in the JAX
// program's order; pow(10, x) is powf, the function torch.pow calls on
// the card.
#pragma once

#include <cstdint>
#include <cuda_runtime.h>

namespace nomad {

constexpr int kE27Bits = 27;
constexpr long long kE27One = 1LL << kE27Bits;
constexpr int kRecipBits = 45;
constexpr int kTermBits = 30;
constexpr int kRsh = kRecipBits - kTermBits;
constexpr long long kTermOne = 1LL << kTermBits;
constexpr float kEps = 1e-9f;

// preempt.py: Q16 coordinates, their clamp, the max_parallel penalty
// unit, the encode gates on the candidate axis and the count groups
constexpr long long kCqOne = 1LL << 16;
constexpr long long kCqCap = 1LL << 30;
constexpr long long kPenaltyUnit = 50;
constexpr long long kBig = 1LL << 62;
constexpr int kCMax = 16;
constexpr int kGpMax = 64;

__device__ __forceinline__ long long floordiv(long long a, long long b) {
  long long q = a / b;
  long long r = a % b;
  if (r != 0 && ((r < 0) != (b < 0))) --q;
  return q;
}

// floor(a / b) for b > 0. Where a and b are exact in a double the
// correctly rounded double quotient is within one of the floor and the
// remainder fixes it up; elsewhere the int64 division. Held against
// torch's floor division on the card by k8_sweep (place_scan.cu).
__device__ __forceinline__ long long floordiv_pos(long long a, long long b) {
  constexpr long long kExact = 1LL << 53;
  if (a <= -kExact || a >= kExact || b >= kExact) return floordiv(a, b);
  long long q = (long long)floor(__ddiv_rn(__ll2double_rn(a), __ll2double_rn(b)));
  long long r = a - q * b;
  while (r < 0) {
    --q;
    r += b;
  }
  while (r >= b) {
    ++q;
    r -= b;
  }
  return q;
}

// jnp.maximum / torch.maximum of x and a constant: NaN in x stays NaN
__device__ __forceinline__ float max_keep_nan(float x, float c) { return x < c ? c : x; }

// the Q27 selection-time exponential of node i on dim d
__device__ __forceinline__ long long e_sel(const int32_t* e_base, const int32_t* e_ask_g,
                                           int i, int d) {
  return ((long long)e_base[i * 2 + d] * (long long)e_ask_g[i * 2 + d]) >> kE27Bits;
}

// x + y and x - y for the carry: int32 adds, or f32 adds rounded alone
__device__ __forceinline__ int32_t add_t(int32_t x, int32_t y) { return x + y; }
__device__ __forceinline__ float add_t(float x, float y) { return __fadd_rn(x, y); }
__device__ __forceinline__ int32_t sub_t(int32_t x, int32_t y) { return x - y; }
__device__ __forceinline__ float sub_t(float x, float y) { return __fsub_rn(x, y); }

// -- score terms (engine.py:484-501 int, :576-584 float) ------------------

// BestFit-v3 binpack in Q30 from the two selection-time exponentials
__device__ __forceinline__ long long binpack_q30(long long e0, long long e1) {
  long long fit = 20 * kE27One - e0 - e1;
  fit = fit < 0 ? 0 : (fit > 18 * kE27One ? 18 * kE27One : fit);
  return (fit * 4) / 9;  // fit >= 0: truncation is floor
}

// job anti-affinity in Q30: -(count + 1) / desired via q_d = 2**45 / desired
__device__ __forceinline__ long long anti_q30(bool present, int tgc, long long q_d) {
  return present ? -((((long long)tgc + 1) * q_d) >> kRsh) : 0;
}

// binpack in f32 from the cpu/mem utilisation and node capacities
__device__ __forceinline__ float binpack_f32(float util_c, float util_m, float node_c,
                                             float node_m) {
  const float free_c = __fsub_rn(1.f, __fdiv_rn(util_c, max_keep_nan(node_c, kEps)));
  const float free_m = __fsub_rn(1.f, __fdiv_rn(util_m, max_keep_nan(node_m, kEps)));
  const float fitness = __fsub_rn(20.f, __fadd_rn(powf(10.f, free_c), powf(10.f, free_m)));
  float clipped = fitness < 0.f ? 0.f : fitness;
  clipped = clipped > 18.f ? 18.f : clipped;
  return __fdiv_rn(clipped, 18.f);
}

__device__ __forceinline__ float anti_f32(bool present, int tgc, float desired_f) {
  return present ? __fdiv_rn(-__fadd_rn((float)tgc, 1.f), desired_f) : 0.f;
}

// -- device-side preemption (preempt.py:171-271; K8, K6, K7) ---------------

// K8: floor square root of 0 <= n < 2**62. The double square root is
// within one of it (n rounds to 53 bits, the root is correctly rounded);
// the integer fix-up makes it exact. Held against isqrt_t on the card by
// k8_sweep (place_scan.cu).
__device__ __forceinline__ long long isqrt64(long long n) {
  long long x = (long long)__dsqrt_rn(__ll2double_rn(n));
  while (x * x > n) --x;
  while ((x + 1) * (x + 1) <= n) ++x;  // (2**31 + 1)**2 < 2**63
  return x;
}

// K8: Q16 coordinate floor((needed - res) * 2**16 / needed), clipped;
// |needed - res| <= 2**29 where needed > 0 (the magnitude gate), so the
// numerator is exact in a double and the product cannot overflow (a left
// shift of a negative value would be undefined in C++17). The double
// quotient is within one of the floor; the remainder fixes it up.
__device__ __forceinline__ long long coord_q(long long needed, long long res) {
  if (needed <= 0) return 0;
  const long long num = (needed - res) * kCqOne;
  long long q = (long long)floor(__ddiv_rn(__ll2double_rn(num), __ll2double_rn(needed)));
  long long r = num - q * needed;
  while (r < 0) {
    --q;
    r += needed;
  }
  while (r >= needed) {
    ++q;
    r -= needed;
  }
  return q < -kCqCap ? -kCqCap : (q > kCqCap ? kCqCap : q);
}

__device__ __forceinline__ long long dist_q(const long long needed[3], const long long res[3]) {
  long long s = 0;
  for (int d = 0; d < 3; ++d) {
    const long long c = coord_q(needed[d], res[d]);
    s += c * c;
  }
  return isqrt64(s);
}

// One candidate slot of a node row, held by one lane of a half-warp:
// lane c holds slot c (lanes past the row's C slots hold a dead slot).
struct PreSlot {
  bool alive;      // eligible and not yet evicted
  int prio;
  long long pen;   // Q16 max_parallel penalty
  long long res[3];
};

// Reductions over the 16 lanes of a half-warp; mask names those lanes.
__device__ __forceinline__ long long half_sum(long long v, unsigned mask) {
  for (int o = 8; o > 0; o >>= 1) v += __shfl_xor_sync(mask, v, o, 16);
  return v;
}

__device__ __forceinline__ int half_min(int v, unsigned mask) {
  for (int o = 8; o > 0; o >>= 1) v = min(v, __shfl_xor_sync(mask, v, o, 16));
  return v;
}

// K6: the greedy sweep of one row over a half-warp. Returns met (the same
// on every lane) and sets *sel to the round that took this lane's slot,
// or -1. First whether evicting every alive slot would meet the ask (the
// greedy takes a subset of them, so otherwise met stays false). Each round
// takes the first slot of least key among the alive slots of the lowest
// priority: one key per lane, then (key, lane) reduced over the lanes; the
// sweep stops once the ask is met or no slot is alive (the later rounds of
// the JAX sweep take nothing then).
__device__ __forceinline__ bool greedy_half(const long long ask[3], const long long rem[3],
                                            const PreSlot& s, int C, unsigned mask, int* sel) {
  const int lane = threadIdx.x & 15;
  *sel = -1;
  bool can = true;
  for (int d = 0; d < 3; ++d) can = can && rem[d] + half_sum(s.alive ? s.res[d] : 0, mask) >= ask[d];
  if (!can) return false;
  long long needed[3] = {ask[0], ask[1], ask[2]};
  long long avail[3] = {rem[0], rem[1], rem[2]};
  bool alive = s.alive;
  for (int t = 0; t < C; ++t) {
    if (!(__ballot_sync(mask, alive) & mask)) break;
    const int pmin = half_min(alive ? s.prio : 2147483647, mask);
    long long key = (alive && s.prio == pmin) ? dist_q(needed, s.res) + s.pen : kBig;
    int who = lane;
    for (int o = 8; o > 0; o >>= 1) {
      const long long k2 = __shfl_xor_sync(mask, key, o, 16);
      const int w2 = __shfl_xor_sync(mask, who, o, 16);
      if (k2 < key || (k2 == key && w2 < who)) {
        key = k2;
        who = w2;
      }
    }
    if (lane == who) {
      alive = false;
      *sel = t;
    }
    bool met = true;
    for (int d = 0; d < 3; ++d) {
      const long long r = __shfl_sync(mask, s.res[d], who, 16);
      avail[d] += r;
      needed[d] -= r;
      met = met && avail[d] >= ask[d];
    }
    if (met) return true;
  }
  return false;
}

// K7 over a half-warp: rank the greedy set by distance to the fresh ask,
// descending, ties in greedy order; keep the shortest rank prefix whose
// resources plus the row's remaining meet the ask (all of the set if none
// does). Returns whether this lane's slot is kept; *rank is its rank
// (INT32_MAX where the greedy did not take it).
__device__ __forceinline__ bool second_pass_half(const long long ask[3], const long long rem[3],
                                                 const PreSlot& s, int sel, unsigned mask,
                                                 int* rank) {
  const bool selected = sel >= 0;
  const long long d2 = selected ? dist_q(ask, s.res) : 0;
  int r = 0;
  for (int o = 0; o < 16; ++o) {
    const long long d2o = __shfl_sync(mask, d2, o, 16);
    const int so = __shfl_sync(mask, sel, o, 16);
    if (so >= 0 && (d2o > d2 || (d2o == d2 && so < sel))) ++r;
  }
  if (!selected) r = 2147483647;
  long long cum[3] = {0, 0, 0};
  for (int o = 0; o < 16; ++o) {
    const int ro = __shfl_sync(mask, r, o, 16);
    for (int d = 0; d < 3; ++d) {
      const long long v = __shfl_sync(mask, s.res[d], o, 16);
      if (ro != 2147483647 && ro <= r) cum[d] += v;
    }
  }
  const bool met = rem[0] + cum[0] >= ask[0] && rem[1] + cum[1] >= ask[1] &&
                   rem[2] + cum[2] >= ask[2];
  const int first_met = half_min(selected && met ? r : 2147483647, mask);
  *rank = r;
  return selected && r <= first_met;
}

// -- the cluster exchange (place_scan.cu, chunk_scan.cu): st.async into a
// CTA's slot, counted by that CTA's transaction barrier ---------------------

__device__ __forceinline__ unsigned smem_u32(const void* p) {
  return (unsigned)__cvta_generic_to_shared(p);
}

__device__ __forceinline__ void mbar_init(unsigned long long* bar) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], 1;\n" ::"r"(smem_u32(bar)) : "memory");
}

// the barrier's one arrival of a phase, expecting `bytes` of st.async
__device__ __forceinline__ void mbar_arm(unsigned long long* bar, int bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(smem_u32(bar)),
               "r"(bytes)
               : "memory");
}

// wait for the phase of this parity to complete; a phase that never does
// (a fault) traps after ~2**24 polls rather than hang the card
__device__ __forceinline__ void mbar_wait(unsigned long long* bar, unsigned parity) {
  unsigned done = 0;
  for (int k = 0; !done; ++k) {
    asm volatile(
        "{\n\t.reg .pred p;\n\t"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n\t"
        "selp.u32 %0, 1, 0, p;\n\t}\n"
        : "=r"(done)
        : "r"(smem_u32(bar)), "r"(parity)
        : "memory");
    if (k == (1 << 24)) asm volatile("trap;\n");
  }
}

// 16 bytes into CTA rank's copy of dst, counted on its copy of bar
__device__ __forceinline__ void st_async16(const void* dst, int rank, unsigned long long* bar,
                                           uint4 v) {
  unsigned rdst, rbar;
  asm volatile("mapa.shared::cluster.u32 %0, %1, %2;\n" : "=r"(rdst) : "r"(smem_u32(dst)), "r"(rank));
  asm volatile("mapa.shared::cluster.u32 %0, %1, %2;\n" : "=r"(rbar) : "r"(smem_u32(bar)), "r"(rank));
  asm volatile(
      "st.async.shared::cluster.mbarrier::complete_tx::bytes.v4.b32 [%0], {%1, %2, %3, %4}, [%5];\n" ::"r"(rdst),
      "r"(v.x), "r"(v.y), "r"(v.z), "r"(v.w), "r"(rbar)
      : "memory");
}

// 8 bytes into CTA rank's copy of dst, counted on its copy of bar
__device__ __forceinline__ void st_async8(const void* dst, int rank, unsigned long long* bar,
                                          unsigned long long v) {
  unsigned rdst, rbar;
  asm volatile("mapa.shared::cluster.u32 %0, %1, %2;\n" : "=r"(rdst) : "r"(smem_u32(dst)), "r"(rank));
  asm volatile("mapa.shared::cluster.u32 %0, %1, %2;\n" : "=r"(rbar) : "r"(smem_u32(bar)), "r"(rank));
  asm volatile("st.async.shared::cluster.mbarrier::complete_tx::bytes.b64 [%0], %1, [%2];\n" ::"r"(rdst),
               "l"(v), "r"(rbar)
               : "memory");
}

// a cluster barrier every thread of every CTA reaches: the writes before
// it (global, shared, distributed shared) are seen by every thread after
__device__ __forceinline__ void cluster_barrier() {
  asm volatile("barrier.cluster.arrive.release.aligned;\n" ::: "memory");
  asm volatile("barrier.cluster.wait.acquire.aligned;\n" ::: "memory");
}

}  // namespace nomad
