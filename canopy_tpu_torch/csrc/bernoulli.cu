// Packed Bernoulli states: one 32-bit word of 32 trials per thread.
//
// Replaces canopy_tpu/ops/pallas_kernels.py:_packed_bernoulli_kernel, which
// seeds the TPU core's generator per (event, word) tile, draws 32 raw words
// per output word in VMEM, compares each against the event's threshold
// floor(p * 2^32) and packs the hits.  The TPU's generator has no CUDA
// counterpart, so each thread here keys Philox4x32-10 on (seed, event)
// with the counter (global word, bit / 4, seed >> 32, 0): one call gives
// four raw words, so eight calls give the word's 32 bits, all in
// registers.  Bit b is set iff raw < thr, compared unsigned; thr = 2^32 - 1
// for p = 1 (a miss only where raw is 2^32 - 1), 0 for p = 0.  The plain
// PyTorch version (ops/bernoulli_kernel.py, packed_bernoulli_plain) draws
// the same bits.
//
// What bounds it on an H100: the integer work.  A word costs 8 Philox
// calls x 10 rounds x (2 wide 32-bit multiplies on the FMA pipe and 2
// three-input XORs on the ALU pipe), plus 32 compares, against 4 bytes
// written; at 64 lanes per pipe and SM the ALU pipe's 192 operations take
// about ten times the time of the store at 3.35 TB/s, so the kernel is
// operations-bound and its design is only to keep every value in
// registers (no shared memory, one coalesced 4-byte store per thread,
// threads of a warp on consecutive words of one event).
// tools/philox_rate.cu measures the rate the card reaches on this work.
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr uint32_t PHILOX_M0 = 0xD2511F53u, PHILOX_M1 = 0xCD9E8D57u;
constexpr uint32_t PHILOX_W0 = 0x9E3779B9u, PHILOX_W1 = 0xBB67AE85u;

__device__ __forceinline__ uint4 philox4x32_10(uint4 c, uint2 k) {
#pragma unroll
  for (int r = 0; r < 10; ++r) {
    if (r) {
      k.x += PHILOX_W0;
      k.y += PHILOX_W1;
    }
    const uint32_t hi0 = __umulhi(PHILOX_M0, c.x), lo0 = PHILOX_M0 * c.x;
    const uint32_t hi1 = __umulhi(PHILOX_M1, c.z), lo1 = PHILOX_M1 * c.z;
    c = make_uint4(hi1 ^ c.y ^ k.x, lo1, hi0 ^ c.w ^ k.y, lo0);
  }
  return c;
}

// thr (n_events,) thresholds, out (n_events, n_words) row-major; thread i
// writes word i % n_words of event i / n_words, global word word0 + that.
__global__ void packed_bernoulli_kernel(const uint32_t* __restrict__ thr,
                                        long long n_events, long long n_words,
                                        uint32_t word0, uint32_t seed_lo,
                                        uint32_t seed_hi,
                                        uint32_t* __restrict__ out) {
  const long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n_events * n_words) return;
  const long long e = i / n_words;
  const uint32_t w = word0 + (uint32_t)(i - e * n_words);
  const uint32_t t = thr[e];
  const uint2 key = make_uint2(seed_lo, (uint32_t)e);
  uint32_t acc = 0;
#pragma unroll
  for (uint32_t j = 0; j < 8; ++j) {
    const uint4 r = philox4x32_10(make_uint4(w, j, seed_hi, 0u), key);
    acc |= ((uint32_t)(r.x < t) << (4 * j)) |
           ((uint32_t)(r.y < t) << (4 * j + 1)) |
           ((uint32_t)(r.z < t) << (4 * j + 2)) |
           ((uint32_t)(r.w < t) << (4 * j + 3));
  }
  out[i] = acc;
}

}  // namespace

extern "C" {

// thr: (n_events,) uint32 bit patterns (int32 storage); out: (n_events,
// n_words) likewise.  word0 + n_words <= 2^32 (checked by the wrapper).
int canopy_packed_bernoulli(const void* thr, long long n_events,
                            long long n_words, long long word0,
                            unsigned int seed_lo, unsigned int seed_hi,
                            void* out, void* stream) {
  constexpr int THREADS = 256;
  const long long total = n_events * n_words;
  const long long blocks = (total + THREADS - 1) / THREADS;
  if (blocks > 0x7FFFFFFFLL) return (int)cudaErrorInvalidConfiguration;
  packed_bernoulli_kernel<<<(unsigned)blocks, THREADS, 0,
                            static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint32_t*>(thr), n_events, n_words, (uint32_t)word0,
      seed_lo, seed_hi, static_cast<uint32_t*>(out));
  return (int)cudaGetLastError();
}

}  // extern "C"
