// Replay-program forward: the top value of every trial.
//
// Replaces canopy_tpu/ops/stream_kernel.py:_replay_kernel, one pallas_call
// per segment that streams the basic replay stream and each segment's
// gathered gate stream through VMEM rings, keeps a Belady pool of gate
// tiles in VMEM, evicts through a slab ring flushed to an HBM log, and
// refills single tiles by DMA.  Here one launch runs the whole program
// (replay_ops.cuh): each thread owns one trial, the pool and resident tier
// sit in shared memory, every basic-stream and eviction-log read arrives
// through a per-thread cp.async prefetch ring, and the op stream through
// TMA-loaded shared-memory chunks.
//
// What bounds it on an H100: the bytes it must move are the basic stream
// (one row per basic read, read once), the eviction log (written once per
// eviction, read once per re-read) and the top, against the uncapped
// stream kernel's pool traffic of every argument and every gate output.
// Latency is what the design fights: the shared-memory pool caps an SM
// at a few hundred trials, and the ring keeps D - 1 reads in flight per
// trial instead of one.
//
// Built with --fmad=false: every multiply and add rounds on its own, in
// the plain PyTorch version's order (stream_ops.cuh eval_op_with, the body
// the stream and fused kernels run), so kernel, plain version and the
// stream kernel on the same tree agree bit for bit.
#include "replay_ops.cuh"

using namespace canopy;

extern "C" {

// As launch_replay_forward (replay_ops.cuh); vlog is not written.
int canopy_replay_forward_f32(const int* words, int n_chunks,
                              int chunk_words, const int* head,
                              const float* staged, const float* house,
                              float* evlog, float* vlog, float* top,
                              long long T, int pool_slots, int res_rows,
                              int top_slot, int W, int depth, float* dp,
                              void* stream) {
  return launch_replay_forward<float, false>(
      words, n_chunks, chunk_words, head, staged, house, evlog, vlog, top, T,
      pool_slots, res_rows, top_slot, W, depth, dp, stream);
}

int canopy_replay_forward_f64(const int* words, int n_chunks,
                              int chunk_words, const int* head,
                              const double* staged, const double* house,
                              double* evlog, double* vlog, double* top,
                              long long T, int pool_slots, int res_rows,
                              int top_slot, int W, int depth, double* dp,
                              void* stream) {
  return launch_replay_forward<double, false>(
      words, n_chunks, chunk_words, head, staged, house, evlog, vlog, top, T,
      pool_slots, res_rows, top_slot, W, depth, dp, stream);
}

}  // extern "C"
