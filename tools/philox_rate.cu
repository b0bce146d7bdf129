// Rate probe for the Philox Bernoulli kernel's integer work.
//
// Each thread makes `reps` packed words exactly as packed_bernoulli_kernel
// (canopy_tpu_torch/csrc/bernoulli.cu, included below) makes one: eight
// Philox4x32-10 calls keyed on a per-thread event, 32 compares against the
// threshold and the packing.  It stores only the XOR of its words, so the
// time is that arithmetic alone: no threshold load, no index division, one
// 4-byte store per `reps` words.  chip_smoke.py builds it beside the
// package (same nvcc flags), counts its loop's SASS by kind and times it,
// which gives the instructions per clock per SM the card reaches on this
// mix of wide multiplies (FMA pipe) and three-input XORs and compares
// (ALU pipe); pipe_rate_kernel times each pipe alone and both together.
//
// Build: nvcc -gencode arch=compute_90a,code=sm_90a -O3 --fmad=false
//        -Xcompiler -fPIC -shared -o philox_rate.so tools/philox_rate.cu
#include "../canopy_tpu_torch/csrc/bernoulli.cu"

namespace {

__global__ void philox_rate_kernel(uint32_t t, uint32_t seed_lo,
                                   uint32_t seed_hi, int reps,
                                   uint32_t* __restrict__ out) {
  const uint32_t i = blockIdx.x * blockDim.x + threadIdx.x;
  const uint32_t stride = gridDim.x * blockDim.x;
  uint32_t fold = 0;
#pragma unroll 1
  for (int r = 0; r < reps; ++r) {
    // A new word and a new event key each time, as each thread of the
    // kernel has, so nothing of one word carries over to the next.
    const uint32_t w = i + (uint32_t)r * stride;
    const uint2 key = make_uint2(seed_lo, i ^ (uint32_t)r);
    uint32_t acc = 0;
#pragma unroll
    for (uint32_t j = 0; j < 8; ++j) {
      const uint4 x = philox4x32_10(make_uint4(w, j, seed_hi, 0u), key);
      acc |= ((uint32_t)(x.x < t) << (4 * j)) |
             ((uint32_t)(x.y < t) << (4 * j + 1)) |
             ((uint32_t)(x.z < t) << (4 * j + 2)) |
             ((uint32_t)(x.w < t) << (4 * j + 3));
    }
    fold ^= acc;
  }
  out[i] = fold;
}

// Pipe probe: 8 independent chains per thread, 4 steps of each per loop
// trip.  MODE 0: the wide multiply alone (mul.wide.u32, IMAD.WIDE.U32 in
// SASS; both halves feed the next step, so it stays wide); MODE 1: the
// three-input XOR alone (lop3.b32, LOP3); MODE 2: one of each per step,
// on separate chains.  MODE 2's rate against MODE 0's and MODE 1's says
// whether the FMA and ALU pipes issue side by side.
template <int MODE>
__global__ void pipe_rate_kernel(int reps, uint32_t* __restrict__ out) {
  const uint32_t i = blockIdx.x * blockDim.x + threadIdx.x;
  const uint32_t c = PHILOX_W0;
  uint32_t x[8], y[8], a[8], b[8];
#pragma unroll
  for (int k = 0; k < 8; ++k) {
    x[k] = i + k;
    y[k] = PHILOX_M0 ^ k;
    a[k] = i ^ (k << 8);
    b[k] = PHILOX_M1 + k;
  }
#pragma unroll 1
  for (int r = 0; r < reps; ++r) {
#pragma unroll
    for (int s = 0; s < 4; ++s) {
#pragma unroll
      for (int k = 0; k < 8; ++k) {
        if (MODE != 1) {
          uint64_t p;
          asm volatile("mul.wide.u32 %0, %1, %2;"
                       : "=l"(p) : "r"(x[k]), "r"(y[k]));
          x[k] = (uint32_t)p;
          y[k] = (uint32_t)(p >> 32);
        }
        if (MODE != 0) {
          asm volatile("lop3.b32 %0, %1, %2, %3, 0x96;"
                       : "=r"(a[k]) : "r"(a[k]), "r"(b[k]), "r"(c));
        }
      }
    }
  }
  uint32_t fold = 0;
#pragma unroll
  for (int k = 0; k < 8; ++k) fold ^= x[k] ^ y[k] ^ a[k];
  out[i] = fold;
}

}  // namespace

extern "C" {

// MODE 0, 1 or 2 of pipe_rate_kernel; out: (blocks * threads,) words.
int canopy_pipe_rate(int mode, int reps, int blocks, int threads, void* out,
                     void* stream) {
  auto* o = static_cast<uint32_t*>(out);
  auto s = static_cast<cudaStream_t>(stream);
  if (mode == 0) {
    pipe_rate_kernel<0><<<blocks, threads, 0, s>>>(reps, o);
  } else if (mode == 1) {
    pipe_rate_kernel<1><<<blocks, threads, 0, s>>>(reps, o);
  } else {
    pipe_rate_kernel<2><<<blocks, threads, 0, s>>>(reps, o);
  }
  return (int)cudaGetLastError();
}

// out: (blocks * threads,) uint32 words; returns a cudaError_t.
int canopy_philox_rate(unsigned int t, unsigned int seed_lo,
                       unsigned int seed_hi, int reps, int blocks,
                       int threads, void* out, void* stream) {
  philox_rate_kernel<<<blocks, threads, 0,
                       static_cast<cudaStream_t>(stream)>>>(
      t, seed_lo, seed_hi, reps, static_cast<uint32_t*>(out));
  return (int)cudaGetLastError();
}

}  // extern "C"
