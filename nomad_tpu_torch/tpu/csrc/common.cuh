// Arithmetic shared by the placement scan (place_scan.cu) and the
// forced-node kernel (forced_eval.cu): the Q-format constants of the int
// spec (nomad_tpu/tpu/intscore.py), the score terms both kernels compute
// for a node, and the exact integer helpers of device-side preemption
// (nomad_tpu/tpu/preempt.py). One definition keeps the two kernels bit
// for bit equal on the same input, in both arms.
//
// Int arm hold points: floor division of possibly negative int64
// (floordiv; C++ '/' truncates), arithmetic '>>' of negative int64, the
// exact 31-round integer square root (a sqrt of a double is not exact up
// to 2**62). Float arm: every operation rounds on its own (__f*_rn, which
// nvcc never contracts into FMA), in the JAX program's order; pow(10, x)
// is powf, the function torch.pow calls on the card.
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

// K8: floor square root of 0 <= n < 2**62 in 31 restoring rounds
__device__ __forceinline__ long long isqrt64(long long n) {
  long long x = 0, r = n;
  for (int shift = 60; shift >= 0; shift -= 2) {
    const long long bit = 1LL << shift;
    const long long t = x + bit;
    if (r >= t) {
      r -= t;
      x = (x >> 1) + bit;
    } else {
      x >>= 1;
    }
  }
  return x;
}

// K8: Q16 coordinate floor((needed - res) * 2**16 / needed), clipped;
// |needed - res| <= 2**29 where needed > 0 (the magnitude gate), so the
// product cannot overflow (a left shift of a negative value would be
// undefined in C++17)
__device__ __forceinline__ long long coord_q(long long needed, long long res) {
  if (needed <= 0) return 0;
  long long q = floordiv((needed - res) * kCqOne, needed);
  return q < -kCqCap ? -kCqCap : (q > kCqCap ? kCqCap : q);
}

__device__ __forceinline__ long long dist_q(const long long needed[3], const int32_t* res4) {
  long long s = 0;
  for (int d = 0; d < 3; ++d) {
    const long long c = coord_q(needed[d], (long long)res4[d]);
    s += c * c;
  }
  return isqrt64(s);
}

// The candidate slots of one node row, C <= kCMax.
struct PreRow {
  int C;
  const int32_t* res;    // [C,4]
  const int32_t* prio;   // [C]
  const long long* pen;  // [C] Q16 max_parallel penalty
  uint32_t alive;        // bit c: eligible and not yet evicted
  long long remaining[3];
};

// Whether evicting every alive slot of the row would meet the ask: the
// greedy takes a subset of them, so without it met stays false.
__device__ __forceinline__ bool can_meet(const long long ask[3], const PreRow& row) {
  long long most[3] = {row.remaining[0], row.remaining[1], row.remaining[2]};
  for (int c = 0; c < row.C; ++c)
    if ((row.alive >> c) & 1u)
      for (int d = 0; d < 3; ++d) most[d] += row.res[c * 4 + d];
  return most[0] >= ask[0] && most[1] >= ask[1] && most[2] >= ask[2];
}

// K6: the greedy sweep of one row. Sets sel_ord[c] (the round that took
// slot c, or -1) when sel_ord is not null; returns met. Each round takes
// the first slot of least key among the alive slots of the lowest
// priority; the sweep stops once the ask is met or no slot is alive (the
// later rounds of the JAX sweep take nothing then). keys counts the keys
// computed.
__device__ __forceinline__ bool greedy_row(const long long ask[3], const PreRow& row,
                                           int8_t* sel_ord, int* keys) {
  long long needed[3] = {ask[0], ask[1], ask[2]};
  long long avail[3] = {row.remaining[0], row.remaining[1], row.remaining[2]};
  uint32_t alive = row.alive;
  if (sel_ord)
    for (int c = 0; c < row.C; ++c) sel_ord[c] = -1;
  for (int t = 0; t < row.C && alive; ++t) {
    int pmin = 2147483647;
    for (int c = 0; c < row.C; ++c)
      if (((alive >> c) & 1u) && row.prio[c] < pmin) pmin = row.prio[c];
    long long best = kBig;
    int best_c = -1;
    for (int c = 0; c < row.C; ++c) {
      if (!((alive >> c) & 1u) || row.prio[c] != pmin) continue;
      const long long key = dist_q(needed, row.res + c * 4) + row.pen[c];
      if (keys) ++*keys;
      if (key < best) {
        best = key;
        best_c = c;
      }
    }
    alive &= ~(1u << best_c);
    if (sel_ord) sel_ord[best_c] = (int8_t)t;
    bool met = true;
    for (int d = 0; d < 3; ++d) {
      const long long r = row.res[best_c * 4 + d];
      avail[d] += r;
      needed[d] -= r;
      met = met && avail[d] >= ask[d];
    }
    if (met) return true;
  }
  return false;
}

// K7: rank the greedy set by distance to the fresh ask, descending, ties
// in greedy order; keep the shortest rank prefix whose resources plus the
// row's remaining meet the ask. rank[c] is set for the selected slots;
// returns the kept slots as a bit mask.
__device__ __forceinline__ uint32_t second_pass_row(const long long ask[3], const PreRow& row,
                                                    const int8_t* sel_ord, int* rank) {
  long long d2[kCMax];
  for (int c = 0; c < row.C; ++c) d2[c] = sel_ord[c] >= 0 ? dist_q(ask, row.res + c * 4) : 0;
  for (int c = 0; c < row.C; ++c) {
    rank[c] = 2147483647;
    if (sel_ord[c] < 0) continue;
    int r = 0;
    for (int o = 0; o < row.C; ++o)
      if (sel_ord[o] >= 0 && (d2[o] > d2[c] || (d2[o] == d2[c] && sel_ord[o] < sel_ord[c]))) ++r;
    rank[c] = r;
  }
  // walk the ranks in order until the prefix meets the ask
  long long avail[3] = {row.remaining[0], row.remaining[1], row.remaining[2]};
  uint32_t keep = 0;
  for (int r = 0; r < row.C; ++r) {
    int c = -1;
    for (int o = 0; o < row.C; ++o)
      if (sel_ord[o] >= 0 && rank[o] == r) c = o;
    if (c < 0) break;
    keep |= 1u << c;
    bool met = true;
    for (int d = 0; d < 3; ++d) {
      avail[d] += row.res[c * 4 + d];
      met = met && avail[d] >= ask[d];
    }
    if (met) break;
  }
  return keep;
}

}  // namespace nomad
