// Reverse pass of a stream program: d top / d staged basics.
//
// Replaces canopy_tpu/ops/adjoint_kernel.py:_adjoint_kernel (with its
// per-gate partials _bgate_accumulate).  The TPU kernel replays an HBM
// argument tape (about three rows per gate) through a VMEM ring and
// schedules its adjoint pool and gradient-staging flushes to fit VMEM.
// Here argument values come from the forward's value log (one row per
// gate output) or from the staged input.
//
// Level-parallel, gather form (importance: one f64 trial).  One thread
// walking 10,483 ops in series is a chain of dependent loads; here a
// block's threads share the (op, trial) items of one level
// (ops/stream_kernel.level_schedule), in reverse level order with a
// barrier between levels, and nothing is accumulated by two threads:
//   * an op's adjoint is the left fold, from 0 (from the cotangent for
//     the top op), of its consumers' edge partials in the consumer-list
//     order (consumer op descending, argument position ascending);
//   * the op writes each argument's partial to that argument's own edge
//     slot (one per row of the argument table, (n_args, n_trials));
//   * a staged row's gradient folds its consumers' edge slots at the end.
// That is the order in which the sequential reverse walk
// (stream_backward_plain) accumulates each pool slot and gradient row, so
// the kernel is bit-equal to it.  The log sits in shared memory when the
// tile's log fits.  Any trial count runs; the edge buffer (n_args x
// n_trials) is what bounds it.
//
// The same kernel is the replay backward (replaces canopy_tpu/ops/
// replay_adjoint_kernel.py:_bwd_kernel, the replay program's reverse walk
// in segments with an adjoint pool in VMEM and an adjoint log in HBM).
// ops/replay_adjoint_kernel.replay_level_program rewrites a replay
// program as a stream program: each EVICT and REFILL becomes a SPILL-kind
// copy op whose one argument is the slot or log row it reads, so its
// adjoint, the fold of its consumers' edges, passes to that location's
// producer exactly where the sequential walk added it.  Every gradient
// row of the basic replay stream has one reader.
#include "adjoint_ops.cuh"

using namespace canopy;

namespace {

// Edge-slot context of the gather form: x(j) as in the forward, accum
// writes argument j's partial to its edge slot.
template <typename V>
struct EdgeCtx {
  BackReads<V> x;
  const int* __restrict__ args;
  V* edge;
  long long T, t;
  __device__ __forceinline__ void accum(int j, V g, bool flip) const {
    if (flip && args[j * ARG_COLS + 2]) g = -g;
    edge[at(j, T, t)] = g;
  }
};

template <typename V, bool SMEM_LOG>
__global__ void stream_level_backward_kernel(
    const int* __restrict__ ops, const int* __restrict__ args,
    const int* __restrict__ order, const int* __restrict__ level_ptr,
    int n_levels, const int* __restrict__ cons_ptr,
    const int* __restrict__ cons, const int* __restrict__ stage_ptr,
    const int* __restrict__ stage_cons, int n_basic,
    const V* __restrict__ staged, const V* __restrict__ house,
    const V* __restrict__ log, const V* __restrict__ ct, V* edge,
    V* __restrict__ grad, long long T, int tile, int n_log, int top_op,
    V* dp_base) {
  extern __shared__ __align__(16) unsigned char smem[];
  V* slog = reinterpret_cast<V*>(smem);
  const DpScratch<V> dp = dp_scratch(dp_base);
  const long long t0 = (long long)blockIdx.x * tile;
  const int nt = (int)(T - t0 < tile ? T - t0 : tile);
  if (SMEM_LOG) {
    for (int item = threadIdx.x; item < n_log * nt; item += blockDim.x) {
      const int row = item / nt, tl = item % nt;
      slog[(long long)row * tile + tl] = log[at(row, T, t0 + tl)];
    }
    __syncthreads();
  }
  const V* rows = SMEM_LOG ? slog : log;
  const long long stride = SMEM_LOG ? tile : T;
  for (int L = n_levels - 1; L >= 0; --L) {
    const int first = level_ptr[L], m = level_ptr[L + 1] - first;
    for (int item = threadIdx.x; item < m * nt; item += blockDim.x) {
      const int o = order[first + item / nt], tl = item % nt;
      const long long t = t0 + tl;
      const int* op = ops + (long long)o * OP_COLS;
      V a = o == top_op ? ct[t] : V(0);
      for (int c = cons_ptr[o]; c < cons_ptr[o + 1]; ++c)
        a = a + edge[at(cons[c], T, t)];
      const int kind = op[0];
      if (kind == SPILL) {
        edge[at(op[2], T, t)] = a;
      } else if (kind != FILL) {  // FILL: a constant; its adjoint drops
        const BackReads<V> x{args, staged, house, rows, stride,
                             SMEM_LOG ? tl : t, T, t};
        const EdgeCtx<V> ctx{x, args, edge, T, t};
        backward_gate(op, a, ctx, dp);
      }
    }
    __syncthreads();
  }
  for (int item = threadIdx.x; item < n_basic * nt; item += blockDim.x) {
    const int r = item / nt;
    const long long t = t0 + item % nt;
    V g = V(0);
    for (int c = stage_ptr[r]; c < stage_ptr[r + 1]; ++c)
      g = g + edge[at(stage_cons[c], T, t)];
    grad[at(r, T, t)] = g;
  }
}

constexpr int LEVEL_THREADS = 256;

template <typename V>
int launch_level_backward(const int* ops, const int* args, const int* order,
                          const int* level_ptr, int n_levels,
                          const int* cons_ptr, const int* cons,
                          const int* stage_ptr, const int* stage_cons,
                          int n_basic, const V* staged, const V* house,
                          const V* log, const V* ct, V* edge, V* grad,
                          long long T, int tile, int n_log, int top_op,
                          int smem_log, V* dp, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const long long blocks = (T + tile - 1) / tile;
  if (smem_log) {
    const size_t smem = (size_t)n_log * tile * sizeof(V);
    auto kernel = stream_level_backward_kernel<V, true>;
    cudaError_t err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return (int)err;
    kernel<<<(unsigned)blocks, LEVEL_THREADS, smem, s>>>(
        ops, args, order, level_ptr, n_levels, cons_ptr, cons, stage_ptr,
        stage_cons, n_basic, staged, house, log, ct, edge, grad, T, tile,
        n_log, top_op, dp);
  } else {
    stream_level_backward_kernel<V, false>
        <<<(unsigned)blocks, LEVEL_THREADS, 0, s>>>(
            ops, args, order, level_ptr, n_levels, cons_ptr, cons,
            stage_ptr, stage_cons, n_basic, staged, house, log, ct, edge,
            grad, T, tile, n_log, top_op, dp);
  }
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

// grad (n_basic, T), edge (n_args, T) scratch (need not be zeroed);
// order/level_ptr/cons_ptr/cons/stage_ptr/stage_cons from level_schedule;
// dp the count-DP scratch (states, blocks * LEVEL_THREADS) or null.
int canopy_stream_level_backward_f32(
    const int* ops, const int* args, const int* order, const int* level_ptr,
    int n_levels, const int* cons_ptr, const int* cons, const int* stage_ptr,
    const int* stage_cons, int n_basic, const float* staged,
    const float* house, const float* log, const float* ct, float* edge,
    float* grad, long long T, int tile, int n_log, int top_op, int smem_log,
    float* dp, void* stream) {
  return launch_level_backward<float>(
      ops, args, order, level_ptr, n_levels, cons_ptr, cons, stage_ptr,
      stage_cons, n_basic, staged, house, log, ct, edge, grad, T, tile,
      n_log, top_op, smem_log, dp, stream);
}

int canopy_stream_level_backward_f64(
    const int* ops, const int* args, const int* order, const int* level_ptr,
    int n_levels, const int* cons_ptr, const int* cons, const int* stage_ptr,
    const int* stage_cons, int n_basic, const double* staged,
    const double* house, const double* log, const double* ct, double* edge,
    double* grad, long long T, int tile, int n_log, int top_op, int smem_log,
    double* dp, void* stream) {
  return launch_level_backward<double>(
      ops, args, order, level_ptr, n_levels, cons_ptr, cons, stage_ptr,
      stage_cons, n_basic, staged, house, log, ct, edge, grad, T, tile,
      n_log, top_op, smem_log, dp, stream);
}

}  // extern "C"
