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

enum Kind { PROD = 0, PAIR = 1, COUNT = 2, MUX = 3, FILL = 4, SPILL = 5 };
enum Src { POOL = 0, STAGED = 1, HOUSE = 2, LOG = 3 };

constexpr int OP_COLS = 7;
constexpr int ARG_COLS = 5;
// Per-thread count-DP states: a COUNT gate needs hi + 2 of them.
constexpr int MAX_COUNT_STATES = 64;

// Row `row` of a (rows, T) buffer, element of trial t.
__device__ __forceinline__ long long at(int row, long long T, long long t) {
  return (long long)row * T + t;
}

}  // namespace canopy
