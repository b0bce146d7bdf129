// Replay programs on the H100: the forward kernel body, with or without
// the value log, shared by replay.cu (forward) and replay_adjoint.cu
// (taped forward).
//
// The host encoder (ops/stream_kernel.py, encode_replay) flattens every
// segment of a canopy_tpu_torch/compiler/replay.py ReplayProgram into one
// op table in the stream_ops.cuh format, in program order, and resolves
// each read the TPU kernel made from a DMA ring, slab buffer or refill
// target to one of five places:
//
//   POOL  r < P           shared-memory pool slot r (the Belady pool)
//   POOL  P <= r < P + R  shared-memory resident slot r - P (a high-reuse
//                         basic, staged row r - P, loaded once per block)
//   POOL  r >= P + R      eviction-log row r - P - R in device memory
//   STAGED row            row of the basic replay stream (brs_len_pad, T)
//   HOUSE i               a house constant
//
// so eval_op runs unchanged with ReplayRows as its pool accessor.  Two
// more ops move values: EVICT (slot -> log row aux0: the store the TPU
// made through its slab ring and flush DMA) and REFILL (log row aux0 ->
// slot: the TPU's rstart/rwait).  Slab reads, refills and the gate replay
// stream the TPU gathered between segments all read known log rows; the
// rings, semaphores, waits and the whole-pool dump/load at segment
// boundaries disappear, and one launch runs every segment with the pool
// in shared memory throughout.
#pragma once

#include "stream_ops.cuh"

namespace canopy {

// Pool accessor of a replay block: shared-memory rows (pool, then the
// resident tier), then the eviction log in device memory.
template <typename V>
struct ReplayRows {
  const V* column;  // shared (P + R, W) array + lane
  int W, n_shared;  // n_shared = P + R
  const V* evlog;   // (n_evicted, T)
  long long T, t;
  __device__ __forceinline__ V operator[](int r) const {
    return r < n_shared ? column[r * W] : evlog[at(r - n_shared, T, t)];
  }
};

// One thread per trial, W = blockDim.x trials per block, the block's pool
// and resident tier a (P + R, W) array of V in dynamic shared memory
// (each thread touches only its own column: no barrier).  With WITH_LOG
// every gate's output is also written to its value-log row op[6].
template <typename V, bool WITH_LOG>
__global__ void replay_forward_kernel(const int* __restrict__ ops,
                                      const int* __restrict__ args, int n_ops,
                                      const V* __restrict__ staged,
                                      const V* __restrict__ house, V* evlog,
                                      V* __restrict__ vlog,
                                      V* __restrict__ top, long long T,
                                      int pool_slots, int res_rows,
                                      int top_slot) {
  extern __shared__ __align__(16) unsigned char smem_bytes[];
  V* shared = reinterpret_cast<V*>(smem_bytes);
  const int W = blockDim.x, lane = threadIdx.x;
  const long long t = (long long)blockIdx.x * W + lane;
  if (t >= T) return;
  V* column = shared + lane;
  for (int i = 0; i < res_rows; ++i)
    column[(pool_slots + i) * W] = staged[at(i, T, t)];
  const ReplayRows<V> rows{column, W, pool_slots + res_rows, evlog, T, t};
  for (int o = 0; o < n_ops; ++o) {
    const int* op = ops + (long long)o * OP_COLS;
    const int kind = op[0];
    if (kind == EVICT) {
      evlog[at(op[4], T, t)] = column[op[1] * W];
    } else if (kind == REFILL) {
      column[op[1] * W] = evlog[at(op[4], T, t)];
    } else {
      const V v = eval_op(op, o, nullptr, args, staged, house, rows, T, t);
      column[op[1] * W] = v;
      if (WITH_LOG) vlog[at(op[6], T, t)] = v;
    }
  }
  top[t] = column[top_slot * W];
}

template <typename V, bool WITH_LOG>
int launch_replay_forward(const int* ops, const int* args, int n_ops,
                          const V* staged, const V* house, V* evlog, V* vlog,
                          V* top, long long T, int pool_slots, int res_rows,
                          int top_slot, int W, void* stream) {
  const size_t smem = (size_t)(pool_slots + res_rows) * W * sizeof(V);
  cudaError_t err = cudaFuncSetAttribute(
      replay_forward_kernel<V, WITH_LOG>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  const long long blocks = (T + W - 1) / W;
  replay_forward_kernel<V, WITH_LOG>
      <<<(unsigned)blocks, W, smem, static_cast<cudaStream_t>(stream)>>>(
          ops, args, n_ops, staged, house, evlog, vlog, top, T, pool_slots,
          res_rows, top_slot);
  return (int)cudaGetLastError();
}

}  // namespace canopy
