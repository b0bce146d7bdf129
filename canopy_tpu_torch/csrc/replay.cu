// Replay-program forward: the top value of every trial.
//
// Replaces canopy_tpu/ops/stream_kernel.py:_replay_kernel, one pallas_call
// per segment that streams the basic replay stream and each segment's
// gathered gate stream through VMEM rings, keeps a Belady pool of gate
// tiles in VMEM, evicts through a slab ring flushed to an HBM log, and
// refills single tiles by DMA.  Here one launch runs the whole program
// (replay_ops.cuh): each thread owns one trial, the pool and resident tier
// sit in shared memory, and every other read is a coalesced row of the
// basic stream or of the eviction log in device memory.
//
// What bounds it on an H100: the bytes it must move are the basic stream
// (one row per basic read, read once), the eviction log (written once per
// eviction, read once per re-read) and the top, against the uncapped
// stream kernel's pool traffic of every argument and every gate output.
// The cost is occupancy: a pool of P + R slots of W trials takes
// (P + R) * W * sizeof(V) of the 232,448 B an SM offers, so at the
// default sizing (1,816 slots at W = 32 in float32) one warp runs per SM
// and the serial chain of op-table reads and dependent loads is
// latency-bound; more trials per thread or op tables staged in shared
// memory would hide it (later work).
//
// Built with --fmad=false: every multiply and add rounds on its own, in
// the plain PyTorch version's order (stream_ops.cuh eval_op, the body the
// stream and fused kernels run), so kernel, plain version and the stream
// kernel on the same tree agree bit for bit.
#include "replay_ops.cuh"

using namespace canopy;

extern "C" {

// staged (brs_len_pad, T), house (n_house + 1,), evlog (max(n_evicted, 1),
// T) scratch, top (T,); W trials per block with (pool_slots + res_rows) *
// W * sizeof(V) bytes of dynamic shared memory.
int canopy_replay_forward_f32(const int* ops, const int* args, int n_ops,
                              const float* staged, const float* house,
                              float* evlog, float* top, long long T,
                              int pool_slots, int res_rows, int top_slot,
                              int W, void* stream) {
  return launch_replay_forward<float, false>(
      ops, args, n_ops, staged, house, evlog, nullptr, top, T, pool_slots,
      res_rows, top_slot, W, stream);
}

int canopy_replay_forward_f64(const int* ops, const int* args, int n_ops,
                              const double* staged, const double* house,
                              double* evlog, double* top, long long T,
                              int pool_slots, int res_rows, int top_slot,
                              int W, void* stream) {
  return launch_replay_forward<double, false>(
      ops, args, n_ops, staged, house, evlog, nullptr, top, T, pool_slots,
      res_rows, top_slot, W, stream);
}

}  // extern "C"
