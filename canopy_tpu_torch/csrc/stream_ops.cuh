// Shared encoding of a stream program for the forward and adjoint kernels.
//
// The host encoder (ops/stream_kernel.py, encode_stream) turns a
// StreamProgram into two int32 tables and one float32 column:
//
//   ops  (n_ops, OP_COLS):  kind, out_slot, arg_begin, arg_end, aux0, aux1,
//                           log_row (-1 for spills)
//   args (n_args, ARG_COLS): src, index, complement flag,
//                           backward value src, backward value index
//   fill (n_ops,):          the constant of a FILL op
//
// aux0 is the inv/iff flag of PROD/PAIR, aux0/aux1 the count window
// [lo, hi] of COUNT.  A SPILL op copies its one staged argument into its
// out_slot.  Values are f32 tiles of one trial per thread; every buffer is
// (rows, n_trials) with trials contiguous so each row read is coalesced.
#pragma once

#include <cuda_runtime.h>

namespace canopy {

// EVICT and REFILL occur in replay programs only (replay_ops.cuh).
enum Kind {
  PROD = 0, PAIR = 1, COUNT = 2, MUX = 3, FILL = 4, SPILL = 5, EVICT = 6,
  REFILL = 7
};
enum Src { POOL = 0, STAGED = 1, HOUSE = 2, LOG = 3 };

constexpr int OP_COLS = 7;
constexpr int ARG_COLS = 5;
// Per-thread count-DP states: a COUNT gate needs hi + 2 of them.
constexpr int MAX_COUNT_STATES = 128;

// Row `row` of a (rows, T) buffer, element of trial t.
__device__ __forceinline__ long long at(int row, long long T, long long t) {
  return (long long)row * T + t;
}

// Pool accessors: row r of the pool column of the thread's trial.
template <typename V>
struct GlobalRows {  // a (slots, T) buffer in device memory
  const V* base;
  long long T, t;
  __device__ __forceinline__ V operator[](int r) const {
    return base[at(r, T, t)];
  }
};

template <typename V>
struct SharedRows {  // a block's (slots, W) shared-memory array
  const V* column;  // base + lane
  int W;
  __device__ __forceinline__ V operator[](int r) const {
    return column[r * W];
  }
};

// Argument `arg` of an op for trial t: a row of the staged (n_basic, T)
// input, a house constant or a pool row; complemented when flagged.
template <typename V, typename Pool>
__device__ __forceinline__ V load_arg(const int* __restrict__ arg,
                                      const V* __restrict__ staged,
                                      const V* __restrict__ house,
                                      const Pool& pool, long long T,
                                      long long t) {
  const int src = arg[0], idx = arg[1];
  V v;
  if (src == POOL) {
    v = pool[idx];
  } else if (src == STAGED) {
    v = staged[at(idx, T, t)];
  } else {
    v = house[idx];
  }
  return arg[2] ? V(1) - v : v;
}

// The value of op `o` for trial t: the one body of the op arithmetic that
// the stream and fused kernels share (fused programs hold no FILL or
// SPILL op and pass no fill column).  With --fmad=false it rounds as the
// plain PyTorch versions do.
template <typename V, typename Pool>
__device__ __forceinline__ V eval_op(const int* __restrict__ op, int o,
                                     const float* __restrict__ fill,
                                     const int* __restrict__ args,
                                     const V* __restrict__ staged,
                                     const V* __restrict__ house,
                                     const Pool& pool, long long T,
                                     long long t) {
#define ARG(j) load_arg(args + (j) * ARG_COLS, staged, house, pool, T, t)
  const int kind = op[0], b = op[2], e = op[3];
  V v;
  if (kind == MUX) {
    const V p = ARG(b), hi = ARG(b + 1), lo = ARG(b + 2);
    v = p * hi + (V(1) - p) * lo;
  } else if (kind == PROD) {
    v = ARG(b);
    for (int j = b + 1; j < e; ++j) v = v * ARG(j);
    if (op[4]) v = V(1) - v;
  } else if (kind == PAIR) {
    const V a = ARG(b), c = ARG(b + 1);
    v = a + c - V(2) * a * c;
    if (op[4]) v = V(1) - v;
  } else if (kind == COUNT) {
    // Poisson-binomial DP with the absorbing state `cap` (">= cap").
    const int lo = op[4], hi = op[5], cap = hi + 1;
    V dp[MAX_COUNT_STATES];
    dp[0] = V(1);
    for (int k = 1; k <= cap; ++k) dp[k] = V(0);
    for (int j = b; j < e; ++j) {
      const V x = ARG(j);
      dp[cap] = dp[cap] + dp[cap - 1] * x;
      for (int k = cap - 1; k >= 1; --k)
        dp[k] = dp[k] * (V(1) - x) + dp[k - 1] * x;
      dp[0] = dp[0] * (V(1) - x);
    }
    v = V(0);
    if (lo <= hi) {
      v = dp[lo];
      for (int k = lo + 1; k <= hi; ++k) v = v + dp[k];
    }
  } else if (kind == FILL) {
    v = V(fill[o]);
  } else {  // SPILL: a long-lived staged basic moves into the pool.
    v = staged[at(args[b * ARG_COLS + 1], T, t)];
  }
  return v;
#undef ARG
}

}  // namespace canopy
