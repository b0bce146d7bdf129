// The taped forward of a replay program: the forward with its value log.
//
// Replaces canopy_tpu/ops/replay_adjoint_kernel.py:_tape_fwd_kernel (the
// replay forward copying every argument it reads into an HBM tape through
// a VMEM slab).  Here it is replay_ops.cuh's ring kernel with its value
// log on: one row per gate output (the design of the stream adjoint)
// instead of one tape row per argument read, about 4x fewer rows on the
// bench trees.  The backward (canopy_tpu/ops/replay_adjoint_kernel.py:
// _bwd_kernel) runs as the stream adjoint's level-parallel gather form
// (adjoint.cu) on the replay program's level form
// (ops/replay_adjoint_kernel.replay_level_program).
//
// Built with --fmad=false, so kernel and plain version agree bit for bit.
#include "replay_ops.cuh"

using namespace canopy;

extern "C" {

// As canopy_replay_forward (replay.cu), with vlog (n_log, T) written.
int canopy_replay_tape_forward_f32(const int* words, int n_chunks,
                                   int chunk_words, const int* head,
                                   const float* staged, const float* house,
                                   float* evlog, float* vlog, float* top,
                                   long long T, int pool_slots, int res_rows,
                                   int top_slot, int W, int depth, float* dp,
                                   void* stream) {
  return launch_replay_forward<float, true>(
      words, n_chunks, chunk_words, head, staged, house, evlog, vlog, top, T,
      pool_slots, res_rows, top_slot, W, depth, dp, stream);
}

int canopy_replay_tape_forward_f64(const int* words, int n_chunks,
                                   int chunk_words, const int* head,
                                   const double* staged, const double* house,
                                   double* evlog, double* vlog, double* top,
                                   long long T, int pool_slots, int res_rows,
                                   int top_slot, int W, int depth,
                                   double* dp, void* stream) {
  return launch_replay_forward<double, true>(
      words, n_chunks, chunk_words, head, staged, house, evlog, vlog, top, T,
      pool_slots, res_rows, top_slot, W, depth, dp, stream);
}

}  // extern "C"
