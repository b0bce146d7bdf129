// Reverse pass of a stream program: d top / d staged basics.
//
// Replaces canopy_tpu/ops/adjoint_kernel.py:_adjoint_kernel (with its
// per-gate partials _bgate_accumulate).  The TPU kernel replays an HBM
// argument tape (about three rows per gate) through a VMEM ring and
// schedules its adjoint pool and gradient-staging flushes to fit VMEM;
// here each thread owns one trial and walks the encoded ops in reverse,
// reading argument values from the forward's value log (one row per gate
// output) or from the staged input, with the adjoint pool a
// (pool_slots, n_trials) scratch in device memory.
//
// What bounds it on an H100: device-memory traffic of log, adjoint-pool
// and gradient rows, about (2 * args + 2) values per op per trial, all
// coalesced.  Templated on the value type like the forward (f32 or
// f64).  The gradient (n_basic, n_trials) and the adjoint pool are zeroed
// by the wrapper; the kernel only accumulates.
//
// At each gate the output's adjoint is read and zeroed BEFORE the
// arguments accumulate: the linear-scan allocator may give an op an out
// slot that one of its own arguments was read from.
#include "adjoint_ops.cuh"

using namespace canopy;

namespace {

template <typename V>
struct Ctx {
  const int* __restrict__ args;
  const V* __restrict__ staged;
  const V* __restrict__ house;
  const V* __restrict__ log;
  V* adj;
  V* grad;
  long long T, t;

  // The value argument j read in the forward (complement applied).
  __device__ __forceinline__ V x(int j) const {
    const int* a = args + j * ARG_COLS;
    const int src = a[3], idx = a[4];
    V v;
    if (src == LOG) {
      v = log[at(idx, T, t)];
    } else if (src == STAGED) {
      v = staged[at(idx, T, t)];
    } else {
      v = house[idx];
    }
    return a[2] ? V(1) - v : v;
  }

  // Accumulate a partial into argument j's adjoint (its complement flag
  // flips the sign, except for MUX whose flags are never set).
  __device__ __forceinline__ void accum(int j, V g, bool flip) const {
    const int* a = args + j * ARG_COLS;
    if (flip && a[2]) g = -g;
    if (a[0] == POOL) {
      adj[at(a[1], T, t)] = adj[at(a[1], T, t)] + g;
    } else if (a[0] == STAGED) {
      grad[at(a[1], T, t)] = grad[at(a[1], T, t)] + g;
    }
  }
};

template <typename V>
__global__ void stream_backward_kernel(const int* __restrict__ ops,
                                       const int* __restrict__ args, int n_ops,
                                       const V* __restrict__ staged,
                                       const V* __restrict__ house,
                                       const V* __restrict__ log,
                                       const V* __restrict__ ct, V* adj,
                                       V* grad, long long T, int top_slot) {
  const long long t = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (t >= T) return;
  const Ctx<V> c{args, staged, house, log, adj, grad, T, t};
  adj[at(top_slot, T, t)] = ct[t];
  for (int o = n_ops - 1; o >= 0; --o) {
    const int* op = ops + (long long)o * OP_COLS;
    const int kind = op[0], out = op[1], b = op[2];
    const V a = adj[at(out, T, t)];
    adj[at(out, T, t)] = V(0);
    if (kind == SPILL) {
      const long long row = at(args[b * ARG_COLS + 1], T, t);
      grad[row] = grad[row] + a;
    } else {
      backward_gate(op, a, c);
    }
    // FILL: a constant; its adjoint is dropped.
  }
}

template <typename V>
int launch_backward(const int* ops, const int* args, int n_ops,
                    const V* staged, const V* house, const V* log, const V* ct,
                    V* adj, V* grad, long long T, int top_slot, void* stream) {
  const int threads = 128;
  const long long blocks = (T + threads - 1) / threads;
  stream_backward_kernel<V><<<(unsigned)blocks, threads, 0,
                              static_cast<cudaStream_t>(stream)>>>(
      ops, args, n_ops, staged, house, log, ct, adj, grad, T, top_slot);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

// grad (n_basic, T) and adj (pool_slots, T) must arrive zeroed.
int canopy_stream_backward_f32(const int* ops, const int* args, int n_ops,
                               const float* staged, const float* house,
                               const float* log, const float* ct, float* adj,
                               float* grad, long long T, int top_slot,
                               void* stream) {
  return launch_backward<float>(ops, args, n_ops, staged, house, log, ct, adj,
                                grad, T, top_slot, stream);
}

int canopy_stream_backward_f64(const int* ops, const int* args, int n_ops,
                               const double* staged, const double* house,
                               const double* log, const double* ct,
                               double* adj, double* grad, long long T,
                               int top_slot, void* stream) {
  return launch_backward<double>(ops, args, n_ops, staged, house, log, ct,
                                 adj, grad, T, top_slot, stream);
}

}  // extern "C"
