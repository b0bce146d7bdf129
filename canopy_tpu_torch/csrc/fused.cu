// Fused whole-tree propagation: every gate of a compiled tree, one launch.
//
// Replaces canopy_tpu/ops/pallas_kernels.py:_make_tiled_kernel (the
// (8, 128)-tile kernel of fused_propagate_tiled) and the lane-row kernel
// of fused_propagate.  The TPU kernels unroll the gate list at trace time
// and keep every gate's trial tile in VMEM.  An H100 block cannot hold
// that many rows at a useful width (n_gates x W x 4 B of shared memory
// held one to four warps per SM), so here the tree runs as a live-row
// program (ops/fused_kernel.fused_program): the gates in the JAX order,
// each writing a row freed by a gate whose last reader has read it, so the
// rows are the peak live set, not every gate.
//
// The kernel is replay_ops.cuh's ring body (the replay and spill
// forward's) with its rows in device memory: each thread owns one trial,
// its rows a column of a (rows, blocks * 128) array whose recent rows stay
// in L1, and a block's shared memory holds only the op stream's two
// TMA-loaded chunks and the per-thread cp.async prefetch ring, through
// which every basic-event argument arrives, issued 7 reads ahead.  Every
// decode is a broadcast shared-memory read, not a dependent device-memory
// load.  Registers are capped for 16 blocks of 128 threads per SM (32 a
// thread, as the stream kernel's one-trial-per-thread kernel has), so an
// SM keeps 64 warps' chains in flight.  House events are constants.  Any
// trial count: the ragged last block's idle threads run on padding
// columns.
//
// The design was measured against the same program with its rows in
// shared memory (spill.cu's kernel, tools/fused_leads.py): a shared-memory
// pool holds an SM to 64-256 trials of these trees, and was 2-5x slower.
//
// What bounds it on an H100: at 2^20 trials the bytes are the staged
// input read once (n_basic x T x 4 B) and the top written once, about
// 1.1 GB for the slice tree, 0.33 ms at 3.35 TB/s; each op is still a
// chain of dependent reads and issues (PERF.md).
//
// Built with --fmad=false: each op's arithmetic is stream_ops.cuh's
// eval_op_with in the plain PyTorch version's order, so kernel, plain
// version and the stream kernel on the same tree agree bit for bit.
#include "replay_ops.cuh"

using namespace canopy;

namespace {

// Threads per block, ring depth and the blocks per SM the registers are
// capped for (ops/fused_kernel.py FUSED_BLOCK_TRIALS, FUSED_RING_DEPTH).
constexpr int FUSED_THREADS = 128;
constexpr int FUSED_DEPTH = 8;
constexpr int FUSED_MIN_BLOCKS = 16;

__global__ void __launch_bounds__(FUSED_THREADS, FUSED_MIN_BLOCKS)
    fused_forward_kernel(const int* __restrict__ words, int n_chunks,
                         int chunk_words, const int* __restrict__ head,
                         const float* __restrict__ staged,
                         const float* __restrict__ house, float* rows,
                         float* __restrict__ top, long long T, int n_rows,
                         int top_row, float* dp_base) {
  ring_forward<float, false, FUSED_DEPTH, true>(
      words, n_chunks, chunk_words, head, staged, house, nullptr, nullptr,
      top, T, n_rows, 0, top_row, rows, dp_base);
}

}  // namespace

extern "C" {

// words (n_chunks * chunk_words,) and head (7,) from replay_ring_stream
// of the live-row program at ring depth 8; staged (n_basic, T) f32, house
// (n_house + 1,) f32, rows (n_rows, blocks * 128) f32 scratch, top (T,)
// f32; W must be 128 and depth 8 (else cudaErrorInvalidValue); dp the
// count-DP scratch (states, blocks * 128) or null.
int canopy_fused_forward_f32(const int* words, int n_chunks, int chunk_words,
                             const int* head, const float* staged,
                             const float* house, float* rows, float* top,
                             long long T, int n_rows, int top_row, int W,
                             int depth, float* dp, void* stream) {
  if (W != FUSED_THREADS || depth != FUSED_DEPTH)
    return (int)cudaErrorInvalidValue;
  return launch_ring(
      fused_forward_kernel,
      ring_shared_bytes<float>(chunk_words, 0, FUSED_DEPTH, FUSED_THREADS),
      T, FUSED_THREADS, static_cast<cudaStream_t>(stream), words, n_chunks,
      chunk_words, head, staged, house, rows, top, T, n_rows, top_row, dp);
}

// Blocks of the fused kernel one SM holds at `shared_bytes` of dynamic
// shared memory (the occupancy calculator: registers, threads and shared
// memory), or -1 on an error.
int canopy_fused_blocks_per_sm(int shared_bytes) {
  int blocks = 0;
  if (cudaFuncSetAttribute(fused_forward_kernel,
                           cudaFuncAttributeMaxDynamicSharedMemorySize,
                           shared_bytes) != cudaSuccess ||
      cudaOccupancyMaxActiveBlocksPerMultiprocessor(
          &blocks, fused_forward_kernel, FUSED_THREADS, shared_bytes) !=
          cudaSuccess)
    return -1;
  return blocks;
}

int canopy_fused_max_smem_bytes() {
  int device = 0, bytes = 0;
  if (cudaGetDevice(&device) != cudaSuccess) return -1;
  if (cudaDeviceGetAttribute(&bytes, cudaDevAttrMaxSharedMemoryPerBlockOptin,
                             device) != cudaSuccess)
    return -1;
  return bytes;
}

}  // extern "C"
