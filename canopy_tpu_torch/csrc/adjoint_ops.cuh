// Per-gate reverse arithmetic of the level-parallel backward (adjoint.cu,
// which serves stream and replay programs): the partials of
// canopy_tpu/ops/adjoint_kernel.py:_bgate_accumulate.
//
// A context C supplies x(j), the forward value of argument j (complement
// applied), and accum(j, g, flip), which hands partial g to argument j
// (negated where flip is set and j is complemented).
#pragma once

#include "stream_ops.cuh"

namespace canopy {

template <typename V, typename D>
__device__ V dp_mass(const D& dp, int len, int a0, int b0) {
  const int lo = a0 > 0 ? a0 : 0;
  const int hi = b0 < len - 1 ? b0 : len - 1;
  if (lo > hi) return V(0);
  V acc = dp[lo];
  for (int k = lo + 1; k <= hi; ++k) acc = acc + dp[k];
  return acc;
}

// The partial of a COUNT op's argument s: the leave-one-out
// Poisson-binomial DP over the other n - 1 arguments, states growing up
// to cap + 1 in dp.  The partial is P(c in [lo - 1, hi - 1]) - P(c in
// [lo, hi]); for an upper-open window (hi >= n) it is P(c = lo - 1),
// which the DP absorbing at lo holds exactly.
template <typename V, typename D, typename C>
__device__ __forceinline__ V count_partial(const int* op, int s, D dp,
                                           const C& c) {
  const int b = op[2], e = op[3], lo_n = op[4], hi_n = op[5], n = e - b;
  const int cap = count_cap(lo_n, hi_n, n);
  int len = 1;
  dp[0] = V(1);
  for (int j = b; j < e; ++j) {
    if (j == s) continue;
    const V v = c.x(j);
    if (len <= cap) {
      dp[len] = dp[len - 1] * v;
      for (int k = len - 1; k >= 1; --k)
        dp[k] = dp[k] * (V(1) - v) + dp[k - 1] * v;
      dp[0] = dp[0] * (V(1) - v);
      ++len;
    } else {  // Absorbing cap beyond what the mass sums need.
      const V last = dp[len - 1];
      for (int k = len - 1; k >= 1; --k)
        dp[k] = dp[k] * (V(1) - v) + dp[k - 1] * v;
      dp[0] = dp[0] * (V(1) - v);
      dp[len - 1] = dp[len - 1] + last * v;
    }
  }
  return hi_n >= n ? dp_mass<V>(dp, len, lo_n - 1, lo_n - 1)
                   : dp_mass<V>(dp, len, lo_n - 1, hi_n - 1) -
                         dp_mass<V>(dp, len, lo_n, hi_n);
}

// Propagate adjoint `a` of gate op `op` (MUX, PROD, PAIR or COUNT) to its
// arguments; FILL and SPILL are the caller's.  A COUNT op wider than
// MAX_COUNT_STATES keeps its DP in the thread's scratch column `dp`.
template <typename V, typename C>
__device__ __forceinline__ void backward_gate(const int* op, V a, const C& c,
                                              const DpScratch<V>& dp) {
  const int kind = op[0], b = op[2], e = op[3];
  if (kind == MUX) {
    const V p = c.x(b), hi = c.x(b + 1), lo = c.x(b + 2);
    c.accum(b, (hi - lo) * a, false);
    c.accum(b + 1, p * a, false);
    c.accum(b + 2, (V(1) - p) * a, false);
  } else if (kind == PROD) {
    const V ae = op[4] ? -a : a;
    const int F = e - b;
    if (F == 1) {
      c.accum(b, ae, true);
    } else if (F == 2) {
      const V x0 = c.x(b), x1 = c.x(b + 1);
      c.accum(b, x1 * ae, true);
      c.accum(b + 1, x0 * ae, true);
    } else {
      // Zero-safe leave-one-out product.
      V total = c.x(b);
      for (int j = b + 1; j < e; ++j) total = total * c.x(j);
      const V x0 = c.x(b);
      V zcnt = x0 == V(0) ? V(1) : V(0);
      V nz = x0 == V(0) ? V(1) : x0;
      for (int j = b + 1; j < e; ++j) {
        const V xj = c.x(j);
        zcnt = zcnt + (xj == V(0) ? V(1) : V(0));
        nz = nz * (xj == V(0) ? V(1) : xj);
      }
      for (int j = b; j < e; ++j) {
        const V xj = c.x(j);
        const bool z = xj == V(0);
        const V safe = z ? V(1) : xj;
        const V part =
            zcnt == V(0) ? total / safe : ((zcnt == V(1) && z) ? nz : V(0));
        c.accum(j, part * ae, true);
      }
    }
  } else if (kind == PAIR) {
    const V ae = op[4] ? -a : a;
    const V x0 = c.x(b), x1 = c.x(b + 1);
    c.accum(b, (V(1) - V(2) * x1) * ae, true);
    c.accum(b + 1, (V(1) - V(2) * x0) * ae, true);
  } else if (kind == COUNT) {
    const bool local = count_cap(op[4], op[5], e - b) < MAX_COUNT_STATES;
    for (int s = b; s < e; ++s) {
      V part;
      if (local) {
        V states[MAX_COUNT_STATES];
        part = count_partial<V>(op, s, LocalDp<V>{states}, c);
      } else {
        part = count_partial<V>(op, s, ScratchDp<V>{dp.column, dp.stride},
                                c);
      }
      c.accum(s, part * a, true);
    }
  }
}

}  // namespace canopy
