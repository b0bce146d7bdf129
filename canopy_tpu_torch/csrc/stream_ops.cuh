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
// [lo, hi] of COUNT over its n = arg_end - arg_begin arguments, as the
// encoders' count_window leaves it: hi >= n marks an upper-open window
// (count >= lo: lo + 1 DP states, absorbing at lo), hi < n a bounded one
// (hi + 2 states, absorbing at hi + 1); a window cheaper to count over the
// complemented arguments arrives with their complement flags flipped.  A
// SPILL op copies its one staged argument into its out_slot.  Every
// buffer is (rows, n_trials) with trials contiguous so each row read is
// coalesced.
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
// Count-DP states (lo + 1 or hi + 2 of them, see above) that one thread
// keeps in its own local array; a wider form runs the same recurrence
// over a column of a device-memory scratch (DpScratch).
constexpr int MAX_COUNT_STATES = 128;

// The device-memory count-DP scratch of one thread: a (states, launched
// threads) array, the thread index contiguous, allocated by the wrapper
// only for a program whose count_window forms exceed MAX_COUNT_STATES
// (null otherwise).  State k of the thread sits at column[k * stride].
template <typename V>
struct DpScratch {
  V* column;
  long long stride;
};

// The scratch column of the calling thread (blockIdx.x * blockDim.x +
// threadIdx.x of gridDim.x * blockDim.x threads) in `base`.
template <typename V>
__device__ __forceinline__ DpScratch<V> dp_scratch(V* base) {
  const long long stride = (long long)gridDim.x * blockDim.x;
  return {base == nullptr
              ? nullptr
              : base + (long long)blockIdx.x * blockDim.x + threadIdx.x,
          stride};
}

// DP state arrays of the count recurrences: a thread-local array, or the
// thread's scratch column.  Both run the same code, in the same order.
template <typename V>
struct LocalDp {
  V* a;
  __device__ __forceinline__ V& operator[](int k) const { return a[k]; }
};
template <typename V>
struct ScratchDp {
  V* column;
  long long stride;
  __device__ __forceinline__ V& operator[](int k) const {
    return column[k * stride];
  }
};

// The absorbing state of a count window [lo, hi] over n arguments.
__device__ __forceinline__ int count_cap(int lo, int hi, int n) {
  return hi >= n ? lo : hi + 1;
}

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

// Forward reads of a stream, fused, replay or spill kernel: argument j
// of the op table from the pool, the staged input or a house constant.
template <typename V, typename Pool>
struct ArgLoader {
  const int* __restrict__ args;
  const V* __restrict__ staged;
  const V* __restrict__ house;
  const Pool& pool;
  long long T, t;
  __device__ __forceinline__ V operator()(int j) const {
    return load_arg(args + j * ARG_COLS, staged, house, pool, T, t);
  }
};

// Reads of the level-parallel kernels: argument j by its backward source
// (columns 3-4: the log row of the op that wrote it, its staged row or
// its house constant), complement applied.  Log row r of the trial sits
// at log[r * stride + col].
template <typename V>
struct BackReads {
  const int* __restrict__ args;
  const V* __restrict__ staged;
  const V* __restrict__ house;
  const V* log;
  long long stride, col;
  long long T, t;
  __device__ __forceinline__ V operator()(int j) const {
    const int* a = args + j * ARG_COLS;
    const int src = a[3], idx = a[4];
    V v;
    if (src == LOG) {
      v = log[(long long)idx * stride + col];
    } else if (src == STAGED) {
      v = staged[at(idx, T, t)];
    } else {
      v = house[idx];
    }
    return a[2] ? V(1) - v : v;
  }
};

// The Poisson-binomial DP of a COUNT op over states dp[0..cap], the
// absorbing state `cap` (">= cap"), its arguments read through x(j).
template <typename V, typename D, typename X>
__device__ __forceinline__ V count_value(const int* __restrict__ op, D dp,
                                         const X& x) {
  const int b = op[2], e = op[3], lo = op[4], hi = op[5], n = e - b;
  const int cap = count_cap(lo, hi, n);
  dp[0] = V(1);
  for (int k = 1; k <= cap; ++k) dp[k] = V(0);
  for (int j = b; j < e && cap >= 1; ++j) {
    const V xj = x(j);
    dp[cap] = dp[cap] + dp[cap - 1] * xj;
    for (int k = cap - 1; k >= 1; --k)
      dp[k] = dp[k] * (V(1) - xj) + dp[k - 1] * xj;
    dp[0] = dp[0] * (V(1) - xj);
  }
  if (hi >= n) return dp[lo];
  V v = V(0);
  if (lo <= hi) {
    v = dp[lo];
    for (int k = lo + 1; k <= hi; ++k) v = v + dp[k];
  }
  return v;
}

// The value of one op, its arguments read through x(j) (the argument
// table row j, complement applied): the one body of the op arithmetic
// that every forward kernel shares.  With --fmad=false it rounds as the
// plain PyTorch versions do.  A SPILL op's one argument is its staged
// row, so x(b) is the value it copies.  A COUNT op wider than
// MAX_COUNT_STATES keeps its DP in the thread's scratch column `dp`.
template <typename V, typename X>
__device__ __forceinline__ V eval_op_with(const int* __restrict__ op,
                                          V fill_value, const X& x,
                                          const DpScratch<V>& dp) {
  const int kind = op[0], b = op[2], e = op[3];
  V v;
  if (kind == MUX) {
    const V p = x(b), hi = x(b + 1), lo = x(b + 2);
    v = p * hi + (V(1) - p) * lo;
  } else if (kind == PROD) {
    v = x(b);
    for (int j = b + 1; j < e; ++j) v = v * x(j);
    if (op[4]) v = V(1) - v;
  } else if (kind == PAIR) {
    const V a = x(b), c = x(b + 1);
    v = a + c - V(2) * a * c;
    if (op[4]) v = V(1) - v;
  } else if (kind == COUNT) {
    if (count_cap(op[4], op[5], e - b) < MAX_COUNT_STATES) {
      V local[MAX_COUNT_STATES];
      v = count_value<V>(op, LocalDp<V>{local}, x);
    } else {
      v = count_value<V>(op, ScratchDp<V>{dp.column, dp.stride}, x);
    }
  } else if (kind == FILL) {
    v = V(fill_value);
  } else {  // SPILL: a long-lived staged basic moves into the pool.
    v = x(b);
  }
  return v;
}

// eval_op_with reading the op table's forward sources for trial t.
template <typename V, typename Pool>
__device__ __forceinline__ V eval_op(const int* __restrict__ op, int o,
                                     const float* __restrict__ fill,
                                     const int* __restrict__ args,
                                     const V* __restrict__ staged,
                                     const V* __restrict__ house,
                                     const Pool& pool, long long T,
                                     long long t, const DpScratch<V>& dp) {
  const ArgLoader<V, Pool> x{args, staged, house, pool, T, t};
  return eval_op_with(op, fill != nullptr ? V(fill[o]) : V(0), x, dp);
}

}  // namespace canopy
