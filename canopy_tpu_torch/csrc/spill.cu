// Spill-program forward: the top value of every trial.
//
// Replaces canopy_tpu/ops/stream_kernel.py:_spill_kernel, one pallas_call
// per segment of a compiler/spill.py program: chunks of the staged basics
// stream through a ring of VMEM buffers, a Belady-scheduled pool of tiles
// sits in VMEM, evictions go through a slab ring whose flush DMAs append
// to an HBM scratch array, single-tile refill DMAs bring values back, and
// at each segment boundary the whole pool is dumped to scratch and
// reloaded.  The host encoder (ops/stream_kernel.py, encode_spill)
// resolves that choreography once into one op table: gate arguments read
// a pool slot, a staged row or a house constant; a SPILL op copies a
// staged row into a slot (staging-buffer spills and refills from the
// staged array); EVICT stores a slot to the scratch row its flush names
// and REFILL loads one back.  The pool never leaves shared memory, so
// the dump and load have no counterpart.
//
// A spill program has a replay program's shape, so it runs replay_ops.cuh's
// ring kernel (replay.cu's body): the pool in shared memory and no
// resident tier, the scratch rows in the eviction log's place and the
// staged (n_basic, T) input in the basic stream's.  Every staged read
// (gate argument or SPILL) and every REFILL takes the next entry of a
// per-thread cp.async prefetch ring, issued D - 1 entries ahead, and the
// op stream (ops/stream_kernel.replay_ring_stream) arrives in TMA-loaded
// shared-memory chunks.  Block width and ring depth come from the pool
// (ops/stream_kernel.replay_plan).
//
// What bounds it on an H100: the staged rows it reads, the scratch rows
// it stores and reloads, and the top; against them it does a few
// operations per byte, so it is bytes-bound on paper.  In practice each
// op is a chain of dependent shared-memory reads and issues, and an SM
// runs as many chains as the pool lets it hold trials (PERF.md).
//
// Built with --fmad=false: each op's arithmetic is stream_ops.cuh's
// eval_op_with in the plain PyTorch version's order, so kernel, plain
// version and the stream kernel on the same tree agree bit for bit.
#include "replay_ops.cuh"

using namespace canopy;

extern "C" {

// words (n_chunks * chunk_words,) and head (depth - 1,) from
// replay_ring_stream; staged (n_basic, T), house (n_house + 1,), scratch
// (max(n_scratch, 1), T), top (T,); W trials per block, ring depth 8, 16,
// 32 or 64; dp the count-DP scratch (states, blocks * W) or null.
int canopy_spill_forward_f32(const int* words, int n_chunks,
                             int chunk_words, const int* head,
                             const float* staged, const float* house,
                             float* scratch, float* top, long long T,
                             int pool_slots, int top_slot, int W, int depth,
                             float* dp, void* stream) {
  return launch_replay_forward<float, false>(
      words, n_chunks, chunk_words, head, staged, house, scratch, nullptr,
      top, T, pool_slots, 0, top_slot, W, depth, dp, stream);
}

int canopy_spill_forward_f64(const int* words, int n_chunks,
                             int chunk_words, const int* head,
                             const double* staged, const double* house,
                             double* scratch, double* top, long long T,
                             int pool_slots, int top_slot, int W, int depth,
                             double* dp, void* stream) {
  return launch_replay_forward<double, false>(
      words, n_chunks, chunk_words, head, staged, house, scratch, nullptr,
      top, T, pool_slots, 0, top_slot, W, depth, dp, stream);
}

}  // extern "C"
