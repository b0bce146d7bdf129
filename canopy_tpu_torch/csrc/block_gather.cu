// Block-gather level kernels: one level of a locality-reordered product
// tree, 128-gate chunks reading one window of rows.
//
// Replaces canopy_tpu/ops/block_gather.py:_level_kernel (log mode) and
// _level_kernel_direct (direct mode).  Per 128-gate chunk the TPU kernels
// copy one contiguous row range (r_rows rows from the chunk's start), the
// level's resident 128-row slabs and 8 neutral rows of value 1 into VMEM,
// and select each gate's arguments with one-hot matrix products on the
// matrix unit.  On Hopper the selection is an index into the window,
// resolved to a row of the value matrix and read from device memory:
//
//   window row s:  s < r_rows            -> row chunk_start + s
//                  s < r_rows + 128 * w  -> row of resident slab
//                                           (s - r_rows) / 128
//                  otherwise             -> neutral (value 1)
//
//   log:     y = sum_f L(sel[g, f]) in f order, where a selection below
//            c_rows reads log v and one at or above it reads log(1 - v)
//            of window row sel - c_rows; out = inv + (1 - 2 inv) exp(y)
//   direct:  acc = prod_f (flip + (1 - 2 flip) x[sel_raw]) in f order;
//            out = inv + (1 - 2 inv) acc
//
// with each log clamped as max(log(max(v, 0)), -1e4): the JAX package's
// max(v, 1e-300) floor is 0 in float32, so log(0) = -inf clamps to -1e4
// and exp(-1e4) is exactly 0 (hard 0/1 inputs stay exact).  The logs are
// taken per selected argument, not over the whole doubled window: a chunk
// at fan 8 selects 1,024 arguments from a window of up to 1,520 rows.
//
// A block runs one chunk over a tile of `width` trials (grid: chunks x
// trial tiles, chunks fastest, so the blocks in flight share their
// trials' resident slabs in L2).  Threads over trials read each selected
// row coalesced; threadIdx.y walks the chunk's valid gates, so the
// selection indices a warp reads are uniform (broadcast loads).  Padding
// gates are not written.  No window is staged in shared memory: staging
// a whole window before the arithmetic measured 4.5x slower than these
// direct reads on an H100, on the reordered plant tree at 65,536 trials
// (PERF.md).
//
// What bounds it on an H100: device-memory bytes.  The program's traffic
// model (BlockGatherProgram.hbm_rows_per_level: each chunk's local range,
// the resident slabs once per level, one write per gate row) is 84,200
// rows for the reordered plant tree, 22.1 GB at 65,536 trials, 6.59 ms at
// 3.35 TB/s; its logs and exps (one per edge and one per gate) are about
// 1.3 ms on the SFUs.
//
// Built with --fmad=false: every multiply and add rounds on its own, in
// the plain PyTorch version's order.
#include <cuda_runtime.h>

namespace {

constexpr int kChunk = 128;  // gates per chunk
constexpr int kSlab = 128;   // rows per resident slab
constexpr float kLogClamp = -1e4f;

struct LevelArgs {
  float* vals;          // (n_rows, T) float32, trials contiguous, in place
  long long T;
  const int* starts;    // (n_chunks,) first row of each chunk's range
  const int* resident;  // (max(w, 1),) first row of each resident slab
  const int* sel;       // (n_chunks * 128, fan) window selections
  const float* flip;    // (n_chunks * 128, fan) direct mode's flips
  const float* inv;     // (n_chunks * 128,) 1.0 = complemented output
  int r_rows, w, fan, c_rows, out_start, n_gates, width;
};

__device__ __forceinline__ float clamped_log(float v) {
  return fmaxf(logf(fmaxf(v, 0.0f)), kLogClamp);
}

// Window row s (< c_rows) of the chunk starting at `start`, trial t.
__device__ __forceinline__ float window_row(const LevelArgs& a, int start,
                                            int s, long long t) {
  long long row;
  if (s < a.r_rows) {
    row = start + s;
  } else if (s < a.r_rows + kSlab * a.w) {
    const int k = s - a.r_rows;
    row = a.resident[k / kSlab] + k % kSlab;
  } else {
    return 1.0f;
  }
  return a.vals[row * a.T + t];
}

template <bool LOG>
__global__ void __launch_bounds__(512) block_level_kernel(LevelArgs a) {
  const int c = blockIdx.x;
  const int start = a.starts[c];
  const int gates = min(kChunk, a.n_gates - c * kChunk);
  const long long n_tiles = a.T / a.width;
  for (long long tile = blockIdx.y; tile < n_tiles; tile += gridDim.y) {
    const long long t0 = tile * a.width;
    for (int g = threadIdx.y; g < gates; g += blockDim.y) {
      const long long gi = (long long)c * kChunk + g;
      const int* sel = a.sel + gi * a.fan;
      const float inv = a.inv[gi];
      float* out = a.vals + (a.out_start + gi) * a.T + t0;
      for (int x = threadIdx.x; x < a.width; x += blockDim.x) {
        const long long t = t0 + x;
        float acc = 0.0f;
        if (LOG) {
          for (int f = 0; f < a.fan; ++f) {
            const int s = sel[f];
            const bool comp = s >= a.c_rows;  // reads log(1 - v)
            const float v = window_row(a, start, comp ? s - a.c_rows : s, t);
            const float term = clamped_log(comp ? 1.0f - v : v);
            acc = f == 0 ? term : acc + term;
          }
          acc = expf(acc);
        } else {
          const float* flip = a.flip + gi * a.fan;
          for (int f = 0; f < a.fan; ++f) {
            const float v = window_row(a, start, sel[f], t);
            const float xf = flip[f] + (1.0f - 2.0f * flip[f]) * v;
            acc = f == 0 ? xf : acc * xf;
          }
        }
        out[x] = inv + (1.0f - 2.0f * inv) * acc;
      }
    }
  }
}

}  // namespace

extern "C" {

// One level in place on vals (n_rows, T) float32: gates out_start ..
// out_start + n_gates - 1 from the window selections of each 128-gate
// chunk, width trials per block (T % width == 0).
int canopy_block_gather_level(float* vals, long long T, const int* starts,
                              const int* resident, const int* sel,
                              const float* flip, const float* inv,
                              int n_chunks, int r_rows, int w, int fan,
                              int c_rows, int out_start, int n_gates,
                              int width, int log_mode, void* stream) {
  const LevelArgs a{vals, T, starts, resident, sel, flip, inv, r_rows, w,
                    fan, c_rows, out_start, n_gates, width};
  const int bx = width < 128 ? width : 128;
  const int by = 512 / bx;
  const long long n_tiles = T / width;
  const dim3 grid((unsigned)n_chunks,
                  (unsigned)(n_tiles < 65535 ? n_tiles : 65535));
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (log_mode)
    block_level_kernel<true><<<grid, dim3(bx, by), 0, s>>>(a);
  else
    block_level_kernel<false><<<grid, dim3(bx, by), 0, s>>>(a);
  return (int)cudaGetLastError();
}

}  // extern "C"
