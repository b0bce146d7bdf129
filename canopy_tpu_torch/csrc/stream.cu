// Stream-program forward kernel, with an optional per-gate value log.
//
// Replaces canopy_tpu/ops/stream_kernel.py:_stream_kernel (the VMEM-pool
// stream kernel) and, with the log on, canopy_tpu/ops/adjoint_kernel.py:
// _tape_kernel (the taped forward).  The TPU kernels walk the program over
// (8, 128) trial tiles with a VMEM pool and staging-chunk DMAs; here every
// thread owns one trial and walks the same op list (no divergence), the
// pool is a (pool_slots, n_trials) scratch in device memory with trials
// contiguous, and any trial count works (the ragged edge is masked).
//
// What bounds it on an H100: device-memory traffic of the pool and log
// rows, about (reads + 1 write) values per op per trial; the op table
// is read at one address by all threads of a warp and stays in L1.  The
// design keeps every access coalesced and reads each staged basic row
// only where the program reads it; a shared-memory pool (176 slots x 128
// threads x 4 B = 90 KB for the largest slice module) is later work.
//
// Built with --fmad=false: every multiply and add rounds on its own, in
// the plain PyTorch version's order, so the two agree bit for bit.  The
// value type is a template parameter: float32 for uncertainty batches,
// float64 where precision matters more than bytes (importance's single
// trial, whose mux partials cancel in f32).
#include "stream_ops.cuh"

using namespace canopy;

namespace {

template <typename V, bool WITH_LOG>
__global__ void stream_forward_kernel(const int* __restrict__ ops,
                                      const float* __restrict__ fill,
                                      const int* __restrict__ args, int n_ops,
                                      const V* __restrict__ staged,
                                      const V* __restrict__ house, V* pool,
                                      V* __restrict__ top, V* __restrict__ log,
                                      long long T, int top_slot) {
  const long long t = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (t >= T) return;
  const GlobalRows<V> rows{pool, T, t};
  for (int o = 0; o < n_ops; ++o) {
    const int* op = ops + (long long)o * OP_COLS;
    const V v = eval_op(op, o, fill, args, staged, house, rows, T, t);
    pool[at(op[1], T, t)] = v;
    if (WITH_LOG && op[6] >= 0) log[at(op[6], T, t)] = v;
  }
  top[t] = pool[at(top_slot, T, t)];
}

template <typename V>
int launch_forward(const int* ops, const float* fill, const int* args,
                   int n_ops, const V* staged, const V* house, V* pool, V* top,
                   V* log, long long T, int top_slot, void* stream) {
  const int threads = 128;
  const long long blocks = (T + threads - 1) / threads;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (log != nullptr) {
    stream_forward_kernel<V, true><<<(unsigned)blocks, threads, 0, s>>>(
        ops, fill, args, n_ops, staged, house, pool, top, log, T, top_slot);
  } else {
    stream_forward_kernel<V, false><<<(unsigned)blocks, threads, 0, s>>>(
        ops, fill, args, n_ops, staged, house, pool, top, log, T, top_slot);
  }
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

// top (T,), pool (pool_slots, T) scratch; log (n_log, T) or null.
int canopy_stream_forward_f32(const int* ops, const float* fill,
                              const int* args, int n_ops, const float* staged,
                              const float* house, float* pool, float* top,
                              float* log, long long T, int top_slot,
                              void* stream) {
  return launch_forward<float>(ops, fill, args, n_ops, staged, house, pool,
                               top, log, T, top_slot, stream);
}

int canopy_stream_forward_f64(const int* ops, const float* fill,
                              const int* args, int n_ops,
                              const double* staged, const double* house,
                              double* pool, double* top, double* log,
                              long long T, int top_slot, void* stream) {
  return launch_forward<double>(ops, fill, args, n_ops, staged, house, pool,
                                top, log, T, top_slot, stream);
}

const char* canopy_cuda_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

int canopy_max_count_states() { return MAX_COUNT_STATES; }

}  // extern "C"
