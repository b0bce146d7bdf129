// Gather level kernel: one product block of a level, one thread per
// (gate, trial).
//
// Replaces canopy_tpu/ops/gather_kernel.py:_level_kernel.  The TPU kernel
// walks 16-gate tiles and double-buffers one row DMA per fan-in position
// into VMEM, because its scalar core issues row copies one at a time.  On
// Hopper the rows are read straight from device memory: a block is one
// gate over 256 consecutive trials, so each argument row read by a warp
// is one coalesced 128-byte segment, and the gate's indices, flips and
// masks are uniform across the block (broadcast loads).  For each gate g
// and trial t:
//
//   acc = prod_f (flip[g, f] ? 1 - v[idx[g, f], t] : v[idx[g, f], t])
//
// over the fan-in positions where mask[g, f] is set, in f order, and
// out[t] = inv[g] ? 1 - acc : acc, written to row out_idx[g].  The mask
// matters on ragged blocks: the compiler pads a short argument list with
// slot 0, and the TPU kernel, which ignores the mask, multiplies basic
// event 0 into those positions; here a padded position multiplies in
// nothing, as in the gather engine.  acc starts at 1 and 1 * x == x, so
// on uniform-fan blocks this equals the TPU kernel's product bit for bit.
//
// What bounds it on an H100: device-memory bytes, each argument row read
// and each gate row written once per level: for the reordered plant tree
// (74,904 edges, 9,363 gates) at 65,536 trials 22.1 GB, 6.59 ms at
// 3.35 TB/s.  Rows shared by several gates of a level are re-read (from
// L2 where the reorder keeps them close).
//
// Built with --fmad=false, like the plain PyTorch version's order.
#include <cuda_runtime.h>

namespace {

constexpr int kTrials = 256;  // trials per block

__global__ void __launch_bounds__(kTrials)
    gather_level_kernel(float* vals, long long T, const int* idx,
                        const unsigned char* flip, const unsigned char* mask,
                        const unsigned char* inv, const int* out_idx,
                        int fan) {
  const long long g = blockIdx.x;
  const int* gi = idx + g * fan;
  const unsigned char* gf = flip + g * fan;
  const unsigned char* gm = mask + g * fan;
  float* out = vals + (long long)out_idx[g] * T;
  for (long long t = (long long)blockIdx.y * kTrials + threadIdx.x; t < T;
       t += (long long)gridDim.y * kTrials) {
    float acc = 1.0f;
    for (int f = 0; f < fan; ++f) {
      if (!gm[f]) continue;
      const float v = vals[(long long)gi[f] * T + t];
      acc = acc * (gf[f] ? 1.0f - v : v);
    }
    out[t] = inv[g] ? 1.0f - acc : acc;
  }
}

}  // namespace

extern "C" {

// One product block in place on vals (n_rows, T) float32: n_gates gates
// of fan-in `fan` (idx/flip/mask (n_gates, fan), inv/out_idx (n_gates,)).
int canopy_gather_level(float* vals, long long T, const int* idx,
                        const unsigned char* flip, const unsigned char* mask,
                        const unsigned char* inv, const int* out_idx,
                        int n_gates, int fan, void* stream) {
  const long long tiles = (T + kTrials - 1) / kTrials;
  const unsigned gy = (unsigned)(tiles < 65535 ? tiles : 65535);
  gather_level_kernel<<<dim3((unsigned)n_gates, gy), kTrials, 0,
                        static_cast<cudaStream_t>(stream)>>>(
      vals, T, idx, flip, mask, inv, out_idx, fan);
  return (int)cudaGetLastError();
}

}  // extern "C"
