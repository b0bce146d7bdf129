// Spill-program forward: the top value of every trial.
//
// Replaces canopy_tpu/ops/stream_kernel.py:_spill_kernel, one pallas_call
// per segment of a compiler/spill.py program: chunks of the staged basics
// stream through a ring of VMEM buffers, a Belady-scheduled pool of tiles
// sits in VMEM, evictions go through a slab ring whose flush DMAs append
// to an HBM scratch array, single-tile refill DMAs bring values back, and
// at each segment boundary the whole pool is dumped to scratch and
// reloaded.  The host encoder (ops/stream_kernel.py, encode_spill)
// resolves that choreography once into the op table of stream_ops.cuh:
// gate arguments read a pool slot, a staged row or a house constant; a
// SPILL op copies a staged row into a slot (staging-buffer spills and
// refills from the staged array); EVICT stores a slot to the scratch row
// its flush names and REFILL loads one back.  One launch runs every
// segment, and the pool never leaves shared memory, so the dump and load
// have no counterpart.
//
// Layout: each thread owns one trial and W = blockDim.x trials share a
// block, whose pool is a (pool_slots, W) array in dynamic shared memory;
// the scratch array is (n_scratch, T) in device memory, trials contiguous
// (n_blocks x n_scratch rows of W trials).  A thread reads and writes only
// its own trial's column, in shared memory and in scratch alike, so a
// store to a scratch row followed by a refill of that row needs no
// barrier: program order within the thread is enough.
//
// What bounds it on an H100: the staged rows it reads, the scratch rows
// it stores and reloads, and the top; against them it does a few
// operations per byte, so it is bytes-bound on paper.  In practice, as for
// replay.cu, each op is a serial chain of dependent loads, and the pool's
// shared memory sets how many trials an SM holds (113 slots x 512 trials x
// 4 B by default): the kernel is latency-bound.
//
// Built with --fmad=false: eval_op rounds as the plain PyTorch version
// and the stream kernel do, so all three agree bit for bit.
#include "stream_ops.cuh"

using namespace canopy;

namespace {

template <typename V>
__global__ void spill_forward_kernel(const int* __restrict__ ops,
                                     const int* __restrict__ args, int n_ops,
                                     const V* __restrict__ staged,
                                     const V* __restrict__ house, V* scratch,
                                     V* __restrict__ top, long long T,
                                     int top_slot, V* dp_base) {
  extern __shared__ __align__(16) unsigned char smem_bytes[];
  V* shared = reinterpret_cast<V*>(smem_bytes);
  const int W = blockDim.x, lane = threadIdx.x;
  const long long t = (long long)blockIdx.x * W + lane;
  if (t >= T) return;
  V* column = shared + lane;
  const SharedRows<V> pool{column, W};
  const DpScratch<V> dp = dp_scratch(dp_base);
  for (int o = 0; o < n_ops; ++o) {
    const int* op = ops + (long long)o * OP_COLS;
    const int kind = op[0];
    if (kind == EVICT) {
      scratch[at(op[4], T, t)] = column[op[1] * W];
    } else if (kind == REFILL) {
      column[op[1] * W] = scratch[at(op[4], T, t)];
    } else {  // a gate, or SPILL: a staged row into the pool
      column[op[1] * W] =
          eval_op(op, o, nullptr, args, staged, house, pool, T, t, dp);
    }
  }
  top[t] = column[top_slot * W];
}

template <typename V>
int launch_spill_forward(const int* ops, const int* args, int n_ops,
                         const V* staged, const V* house, V* scratch, V* top,
                         long long T, int pool_slots, int top_slot, int W,
                         V* dp, void* stream) {
  const size_t smem = (size_t)pool_slots * W * sizeof(V);
  cudaError_t err = cudaFuncSetAttribute(
      spill_forward_kernel<V>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (err != cudaSuccess) return (int)err;
  const long long blocks = (T + W - 1) / W;
  spill_forward_kernel<V>
      <<<(unsigned)blocks, W, smem, static_cast<cudaStream_t>(stream)>>>(
          ops, args, n_ops, staged, house, scratch, top, T, top_slot, dp);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

// staged (n_basic, T), house (n_house + 1,), scratch (max(n_scratch, 1), T),
// top (T,); W trials per block with pool_slots * W * sizeof(V) bytes of
// dynamic shared memory; dp the count-DP scratch (states, blocks * W) or
// null.
int canopy_spill_forward_f32(const int* ops, const int* args, int n_ops,
                             const float* staged, const float* house,
                             float* scratch, float* top, long long T,
                             int pool_slots, int top_slot, int W, float* dp,
                             void* stream) {
  return launch_spill_forward<float>(ops, args, n_ops, staged, house,
                                     scratch, top, T, pool_slots, top_slot, W,
                                     dp, stream);
}

int canopy_spill_forward_f64(const int* ops, const int* args, int n_ops,
                             const double* staged, const double* house,
                             double* scratch, double* top, long long T,
                             int pool_slots, int top_slot, int W, double* dp,
                             void* stream) {
  return launch_spill_forward<double>(ops, args, n_ops, staged, house,
                                      scratch, top, T, pool_slots, top_slot,
                                      W, dp, stream);
}

}  // extern "C"
