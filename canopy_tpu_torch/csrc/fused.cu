// Fused whole-tree propagation: every gate of a compiled tree, on chip.
//
// Replaces canopy_tpu/ops/pallas_kernels.py:_make_tiled_kernel (the
// (8, 128)-tile kernel of fused_propagate_tiled) and the lane-row kernel
// of fused_propagate.  The TPU kernels unroll the gate list at trace time
// and keep every gate's trial tile in VMEM; here every thread owns one
// trial and walks one encoded op table (the stream_ops.cuh format, gates
// in level order, the out row being the gate's row), so all threads of a
// warp run the same op (no divergence) and one compiled kernel serves
// every tree.  The gate arithmetic is stream_ops.cuh's eval_op, the
// body stream.cu runs too; only the pool differs.  A block's gate values
// are a (n_gates, W) float32 array in dynamic shared memory, W =
// blockDim.x trials wide (128 for the tiled counterpart, 32 for the
// lane-row one), each thread touching only its own column (conflict-free
// banks, no barrier).  Basic events are read
// straight from the staged (n_basic, T) input, coalesced along trials;
// house events are float32 constants.  Any trial count: the ragged last
// block masks its idle threads.
//
// What bounds it on an H100: at 2^20 trials the bytes are the staged
// input read once (n_basic x T x 4 B) and the top written once, about
// 1.1 GB for the slice tree, 0.33 ms at 3.35 TB/s.  The simple design
// keeps one block of n_gates x W x 4 B of shared memory per SM slot, so
// few warps are resident and the serial chain of table reads and staged
// loads is latency-bound; hiding it (more trials per thread, an op table
// in shared memory, cp.async staging) is later work.
//
// Built with --fmad=false: every multiply and add rounds on its own, in
// the plain PyTorch version's order, so the two agree bit for bit.
#include "stream_ops.cuh"

using namespace canopy;

namespace {

__global__ void fused_forward_kernel(const int* __restrict__ ops,
                                     const int* __restrict__ args, int n_ops,
                                     const float* __restrict__ staged,
                                     const float* __restrict__ house,
                                     float* __restrict__ top, long long T,
                                     int top_row, float* dp_base) {
  extern __shared__ float gates[];  // (n_gates, W), trials contiguous
  const int W = blockDim.x, lane = threadIdx.x;
  const long long t = (long long)blockIdx.x * W + lane;
  if (t >= T) return;  // columns are private: no barrier to keep
  float* column = gates + lane;
  const SharedRows<float> rows{column, W};
  const DpScratch<float> dp = dp_scratch(dp_base);
  for (int o = 0; o < n_ops; ++o) {
    const int* op = ops + (long long)o * OP_COLS;
    column[op[1] * W] =
        eval_op(op, o, nullptr, args, staged, house, rows, T, t, dp);
  }
  top[t] = column[top_row * W];
}

}  // namespace

extern "C" {

// staged (n_basic, T) f32, house (n_house + 1,) f32, top (T,) f32; W
// trials per block with n_gates * W * 4 bytes of dynamic shared memory;
// dp the count-DP scratch (states, blocks * W) or null.
int canopy_fused_forward_f32(const int* ops, const int* args, int n_ops,
                             const float* staged, const float* house,
                             float* top, long long T, int n_gates, int top_row,
                             int W, float* dp, void* stream) {
  const size_t smem = (size_t)n_gates * W * sizeof(float);
  cudaError_t err = cudaFuncSetAttribute(
      fused_forward_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (err != cudaSuccess) return (int)err;
  const long long blocks = (T + W - 1) / W;
  fused_forward_kernel<<<(unsigned)blocks, W, smem,
                         static_cast<cudaStream_t>(stream)>>>(
      ops, args, n_ops, staged, house, top, T, top_row, dp);
  return (int)cudaGetLastError();
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
