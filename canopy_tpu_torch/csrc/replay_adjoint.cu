// Reverse mode of a replay program: the taped forward and the backward.
//
// Replaces canopy_tpu/ops/replay_adjoint_kernel.py: _tape_fwd_kernel (the
// replay forward copying every argument it reads into an HBM tape through
// a VMEM slab) and _bwd_kernel (the backward segments in reverse, each
// split into sub-kernels of at most max_bwd_ops ops, with an adjoint pool
// in VMEM mirroring the forward's slots, an adjoint log scatter-added
// between segments, and a gradient stream laid out like the basic replay
// stream).
//
// The taped forward is replay_ops.cuh's forward kernel with its value log
// on: one row per gate output (the design of the stream adjoint,
// adjoint.cu) instead of one tape row per argument read, about 4x fewer
// rows on the bench trees; the backward reads an argument's forward value from the
// value-log row of the gate that produced it, or from its basic-stream
// row.  The backward walks the flat replay op table (replay_ops.cuh) in
// reverse in one launch, one thread per trial:
//
//   gate    a = adjoint of the out slot, which is then zeroed (an op may
//           write a slot one of its own arguments was read from), and the
//           partials of adjoint_ops.cuh's backward_gate accumulate into
//           each argument's adjoint: a shared-memory pool slot (the
//           forward's slot assignment), an eviction-log adjoint row in
//           device memory (a slab, gate-stream or refill read of a value
//           the forward had evicted), or the gradient-stream row of a
//           basic read;
//   REFILL  the slot's adjoint moves to the log adjoint of the row it was
//           refilled from;
//   EVICT   the log row's accumulated adjoint moves into the slot (whose
//           adjoint is zero there: the slot's later occupant zeroed it).
//
// Accumulating gate-stream cotangents straight into the log adjoint
// replaces the TPU's per-segment icot scatter-add; the sub-kernel split
// existed only because tracing the straight-line TPU kernels grows
// superlinearly and is not needed.  Programs with a resident tier are
// refused by the wrapper (the JAX builder forces it off for the adjoint).
//
// What bounds the backward on an H100: bytes of the value log (one read
// per argument), the eviction-log adjoint (one read-modify-write per
// re-read, one read per eviction) and the gradient stream (one write per
// basic read); the adjoint pool stays on chip, at the forward's occupancy
// cost (replay.cu).  Templated on the value type (f32, f64); the wrapper
// zeroes the log adjoint and the gradient stream.  Built with
// --fmad=false, so kernel and plain version agree bit for bit.
#include "adjoint_ops.cuh"
#include "replay_ops.cuh"

using namespace canopy;

namespace {

template <typename V>
struct ReplayCtx {
  const int* __restrict__ args;
  const V* __restrict__ staged;
  const V* __restrict__ house;
  const V* __restrict__ vlog;
  V* column;  // shared (P, W) adjoint pool + lane
  int W, pool_slots;
  V* adjlog;  // (n_evicted, T) adjoints of the eviction-log rows
  V* grad;    // (brs_len_pad, T) gradient stream
  long long T, t;

  // The value argument j read in the forward (complement applied).
  __device__ __forceinline__ V x(int j) const {
    const int* a = args + j * ARG_COLS;
    const int src = a[3], idx = a[4];
    V v;
    if (src == LOG) {
      v = vlog[at(idx, T, t)];
    } else if (src == STAGED) {
      v = staged[at(idx, T, t)];
    } else {
      v = house[idx];
    }
    return a[2] ? V(1) - v : v;
  }

  __device__ __forceinline__ void accum(int j, V g, bool flip) const {
    const int* a = args + j * ARG_COLS;
    if (flip && a[2]) g = -g;
    const int idx = a[1];
    if (a[0] == POOL) {
      if (idx < pool_slots) {
        column[idx * W] = column[idx * W] + g;
      } else {
        V* row = adjlog + at(idx - pool_slots, T, t);
        *row = *row + g;
      }
    } else if (a[0] == STAGED) {
      grad[at(idx, T, t)] = grad[at(idx, T, t)] + g;
    }
  }
};

template <typename V>
__global__ void replay_backward_kernel(const int* __restrict__ ops,
                                       const int* __restrict__ args, int n_ops,
                                       const V* __restrict__ staged,
                                       const V* __restrict__ house,
                                       const V* __restrict__ vlog,
                                       const V* __restrict__ ct, V* adjlog,
                                       V* grad, long long T, int pool_slots,
                                       int top_slot) {
  extern __shared__ __align__(16) unsigned char smem_bytes[];
  V* shared = reinterpret_cast<V*>(smem_bytes);
  const int W = blockDim.x, lane = threadIdx.x;
  const long long t = (long long)blockIdx.x * W + lane;
  if (t >= T) return;
  V* column = shared + lane;
  for (int s = 0; s < pool_slots; ++s) column[s * W] = V(0);
  column[top_slot * W] = ct[t];
  const ReplayCtx<V> c{args, staged, house, vlog, column, W, pool_slots,
                       adjlog, grad, T, t};
  for (int o = n_ops - 1; o >= 0; --o) {
    const int* op = ops + (long long)o * OP_COLS;
    const int kind = op[0];
    V* slot = column + op[1] * W;
    if (kind == EVICT) {
      *slot = *slot + adjlog[at(op[4], T, t)];
    } else if (kind == REFILL) {
      V* row = adjlog + at(op[4], T, t);
      *row = *row + *slot;
      *slot = V(0);
    } else {
      const V a = *slot;
      *slot = V(0);
      backward_gate(op, a, c);
    }
  }
}

template <typename V>
int launch_replay_backward(const int* ops, const int* args, int n_ops,
                           const V* staged, const V* house, const V* vlog,
                           const V* ct, V* adjlog, V* grad, long long T,
                           int pool_slots, int top_slot, int W, void* stream) {
  const size_t smem = (size_t)pool_slots * W * sizeof(V);
  cudaError_t err = cudaFuncSetAttribute(
      replay_backward_kernel<V>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (err != cudaSuccess) return (int)err;
  const long long blocks = (T + W - 1) / W;
  replay_backward_kernel<V>
      <<<(unsigned)blocks, W, smem, static_cast<cudaStream_t>(stream)>>>(
          ops, args, n_ops, staged, house, vlog, ct, adjlog, grad, T,
          pool_slots, top_slot);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

// The forward with its value log: vlog (n_log, T); as canopy_replay_forward
// otherwise (replay.cu).
int canopy_replay_tape_forward_f32(const int* ops, const int* args,
                                   int n_ops, const float* staged,
                                   const float* house, float* evlog,
                                   float* vlog, float* top, long long T,
                                   int pool_slots, int res_rows, int top_slot,
                                   int W, void* stream) {
  return launch_replay_forward<float, true>(
      ops, args, n_ops, staged, house, evlog, vlog, top, T, pool_slots,
      res_rows, top_slot, W, stream);
}

int canopy_replay_tape_forward_f64(const int* ops, const int* args,
                                   int n_ops, const double* staged,
                                   const double* house, double* evlog,
                                   double* vlog, double* top, long long T,
                                   int pool_slots, int res_rows, int top_slot,
                                   int W, void* stream) {
  return launch_replay_forward<double, true>(
      ops, args, n_ops, staged, house, evlog, vlog, top, T, pool_slots,
      res_rows, top_slot, W, stream);
}

// adjlog (max(n_evicted, 1), T) and grad (brs_len_pad, T) must arrive
// zeroed; ct (T,); W trials per block with pool_slots * W * sizeof(V)
// bytes of dynamic shared memory.
int canopy_replay_backward_f32(const int* ops, const int* args, int n_ops,
                               const float* staged, const float* house,
                               const float* vlog, const float* ct,
                               float* adjlog, float* grad, long long T,
                               int pool_slots, int top_slot, int W,
                               void* stream) {
  return launch_replay_backward<float>(ops, args, n_ops, staged, house, vlog,
                                       ct, adjlog, grad, T, pool_slots,
                                       top_slot, W, stream);
}

int canopy_replay_backward_f64(const int* ops, const int* args, int n_ops,
                               const double* staged, const double* house,
                               const double* vlog, const double* ct,
                               double* adjlog, double* grad, long long T,
                               int pool_slots, int top_slot, int W,
                               void* stream) {
  return launch_replay_backward<double>(ops, args, n_ops, staged, house,
                                        vlog, ct, adjlog, grad, T, pool_slots,
                                        top_slot, W, stream);
}

}  // extern "C"
