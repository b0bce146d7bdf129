// Counter-based draws keyed as jax.random keys them: threefry2x32.
//
// The JAX package has no Pallas kernel here: its expression tape samples
// through jax.random (canopy_tpu/compiler/expr_tape.py:279-357), which XLA
// lowers to threefry2x32 hashes and the float transforms of
// jax/_src/random.py.  These kernels are the port's counterpart of that
// lowering, with the same keys, counters and transforms, so that a seed
// gives the JAX package's draws.  ops/prng.py holds the plain PyTorch
// versions, operation for operation; with --fmad=false every multiply and
// add rounds on its own there and here, and the math library's log1p,
// log, exp, pow and sqrt are the ones torch's CUDA operators call, so the
// kernels and the plain versions agree bit for bit on the card.
//
// draw_standard_kernel fills an (n_trials, ld) float64 block from a table
// of rows (key, kind, transform, stride, offset, column; p0, p1): trial t
// of a row hashes the counter t * stride + offset (split into its high and
// low words) under the row's key.  A block takes 32 trials x 32 rows: each
// warp draws one row for 32 consecutive trials (one kind per warp, so the
// kinds do not diverge), into shared memory; then each warp stores one
// trial's 32 columns, consecutive in the output, so the stores coalesce.
// What bounds it on an H100: the integer work.  A 64-bit draw is one
// threefry2x32 call, 20 rounds of an add, a rotate and a XOR plus six key
// injections: about 80 operations on the ALU pipe (64 lanes per SM and
// clock) against 8 bytes written; the normal's erf_inv adds about 60
// float64 operations.  ALU lanes, not the 3.35 TB/s of the store, set the
// bound (chip_smoke.py counts it).
//
// draw_gamma_kernel runs _gamma_one (jax/_src/random.py) per element, one
// thread each, over one row of n elements per key (a gamma deviate has one
// key, a beta deviate two): element i of a row draws under split(key,
// n)[i], and the rejection loop, its inner redraw of v <= 0 and every key
// split stay in registers.
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int UNIFORM = 0, UNIFORM32 = 1, NORMAL = 2, GUMBEL = 3;
constexpr int NONE = 0, AFFINE = 1, EXP_AFFINE = 2;
constexpr uint32_t PARITY = 0x1BD11BDAu;
constexpr double NORMAL_LO = -0.9999999999999999;  // nextafter(-1, 0)
constexpr double SQRT2 = 1.4142135623730951;
constexpr double TINY = 2.2250738585072014e-308;
constexpr int TILE = 32;
constexpr int WARPS = 8;

// XLA's float64 erf_inv coefficients (ops/prng.py, _ERFINV_A/B/C).
__constant__ double ERFINV_A[23] = {
    -3.64441206401782e-21, -1.6850591381820166e-19, 1.28584807152564e-18,
    1.1157877678025181e-17, -1.3331716628546209e-16, 2.0972767875968562e-17,
    6.6376381343583238e-15, -4.0545662729752069e-14, -8.1519341976054722e-14,
    2.6335093153082323e-12, -1.2975133253453532e-11, -5.4154120542946279e-11,
    1.0512122733215323e-09, -4.1126339803469837e-09, -2.9070369957882005e-08,
    4.2347877827932404e-07, -1.3654692000834679e-06, -1.3882523362786469e-05,
    0.00018673420803405714, -0.000740702534166267, -0.0060336708714301491,
    0.24015818242558962, 1.6536545626831027};
__constant__ double ERFINV_B[19] = {
    2.2137376921775787e-09, 9.0756561938885391e-08, -2.7517406297064545e-07,
    1.8239629214389228e-08, 1.5027403968909828e-06, -4.013867526981546e-06,
    2.9234449089955446e-06, 1.2475304481671779e-05, -4.7318229009055734e-05,
    6.8284851459573175e-05, 2.4031110387097894e-05, -0.00035503752036284748,
    0.0009532893797373805, -0.0016882755560235047, 0.0024914420961078508,
    -0.0037512085075692412, 0.0053709145535900636, 1.0052589676941592,
    3.0838856104922208};
__constant__ double ERFINV_C[17] = {
    -2.7109920616438573e-11, -2.5556418169965252e-10, 1.5076572693500548e-09,
    -3.789465440126737e-09, 7.61570120807834e-09, -1.496002662714924e-08,
    2.9147953450901081e-08, -6.7711997758452339e-08, 2.2900482228026655e-07,
    -9.9298272942317e-07, 4.5260625972231537e-06, -1.9681778105531671e-05,
    7.5995277030017761e-05, -0.00021503011930044477, -0.00013871931833623122,
    1.0103004648645344, 4.8499064014085844};

__device__ __forceinline__ uint32_t rotl(uint32_t v, int r) {
  return (v << r) | (v >> (32 - r));
}

// threefry2x32, 20 rounds (JAX's _threefry2x32_lowering).
__device__ __forceinline__ uint2 threefry(uint2 key, uint32_t x0,
                                          uint32_t x1) {
  const uint32_t ks[3] = {key.x, key.y, key.x ^ key.y ^ PARITY};
  const int rot[2][4] = {{13, 15, 26, 6}, {17, 29, 16, 24}};
  x0 += ks[0];
  x1 += ks[1];
#pragma unroll
  for (int i = 0; i < 5; ++i) {
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      x0 += x1;
      x1 = rotl(x1, rot[i % 2][j]) ^ x0;
    }
    x0 += ks[(i + 1) % 3];
    x1 += ks[(i + 2) % 3] + (uint32_t)(i + 1);
  }
  return make_uint2(x0, x1);
}

// _uniform's float64 in [0, 1) from the 64-bit draw b.x << 32 | b.y.
__device__ __forceinline__ double f64_from_words(uint2 b) {
  const uint64_t bits = ((uint64_t)b.x << 32) | b.y;
  return __longlong_as_double((long long)((bits >> 12) |
                                          0x3FF0000000000000ull)) - 1.0;
}

// _uniform's float32 in [0, 1) from the 32-bit draw b.x ^ b.y.
__device__ __forceinline__ double f32_from_words(uint2 b) {
  const uint32_t bits = ((b.x ^ b.y) >> 9) | 0x3F800000u;
  return (double)(__uint_as_float(bits) - 1.0f);
}

// XLA's float64 erf_inv: the branch of each element, as the compiled
// HLO's selects give it.
__device__ double erf_inv(double x) {
  const double w = -log1p(x * -x);
  double p;
  if (w < 6.25) {
    const double wt = w - 3.125;
    p = ERFINV_A[0];
#pragma unroll
    for (int i = 1; i < 23; ++i) p = ERFINV_A[i] + p * wt;
  } else if (w < 16.0) {
    const double wt = sqrt(w) - 3.25;
    p = ERFINV_B[0];
#pragma unroll
    for (int i = 1; i < 19; ++i) p = ERFINV_B[i] + p * wt;
  } else {
    const double wt = sqrt(w) - 5.0;
    p = ERFINV_C[0];
#pragma unroll
    for (int i = 1; i < 17; ++i) p = ERFINV_C[i] + p * wt;
  }
  return fabs(x) == 1.0 ? x * __longlong_as_double(0x7FF0000000000000ll)
                        : p * x;
}

__device__ __forceinline__ double normal_from_words(uint2 b) {
  const double u = fmax(f64_from_words(b) * 2.0 + NORMAL_LO, NORMAL_LO);
  return SQRT2 * erf_inv(u);
}

__device__ double draw(int kind, uint2 b) {
  switch (kind) {
    case UNIFORM:
      return f64_from_words(b);
    case UNIFORM32:
      return f32_from_words(b);
    case NORMAL:
      return normal_from_words(b);
    default: {  // GUMBEL
      const double u = fmax(f64_from_words(b) + TINY, TINY);
      return -log(-log(u));
    }
  }
}

// rows: (n_rows, 7) int64 (key0, key1, kind, transform, stride, offset,
// col); params: (n_rows, 2) float64; out: (n_trials, ld) float64.
__global__ void draw_standard_kernel(const long long* __restrict__ rows,
                                     const double* __restrict__ params,
                                     int n_rows, long long n_trials, int ld,
                                     double* __restrict__ out) {
  __shared__ double tile[TILE][TILE + 1];
  const int lane = threadIdx.x % 32, warp = threadIdx.x / 32;
  const long long t0 = (long long)blockIdx.x * TILE;
  const int r0 = blockIdx.y * TILE;
  const long long t = t0 + lane;
  for (int rr = warp; rr < TILE; rr += WARPS) {
    const int r = r0 + rr;
    if (r >= n_rows || t >= n_trials) continue;
    const long long* row = rows + 7LL * r;
    const uint2 key = make_uint2((uint32_t)row[0], (uint32_t)row[1]);
    const uint64_t c = (uint64_t)t * (uint64_t)row[4] + (uint64_t)row[5];
    double x = draw((int)row[2], threefry(key, (uint32_t)(c >> 32),
                                          (uint32_t)c));
    const int transform = (int)row[3];
    if (transform != NONE) {
      x = params[2 * r] + params[2 * r + 1] * x;
      if (transform == EXP_AFFINE) x = exp(x);
    }
    tile[lane][rr] = x;
  }
  __syncthreads();
  const int r = r0 + lane;
  if (r >= n_rows) return;
  const long long col = rows[7LL * r + 6];
  for (int tt = warp; tt < TILE; tt += WARPS) {
    const long long ts = t0 + tt;
    if (ts < n_trials) out[ts * ld + col] = tile[tt][lane];
  }
}

__device__ __forceinline__ double uniform_at0(uint2 key) {
  return f64_from_words(threefry(key, 0u, 0u));
}

// _gamma_one (jax/_src/random.py) for one element.
__device__ double gamma_one(uint2 key, double alpha, bool log_space) {
  const double one_third = 1.0 / 3.0;
  const bool boost_mask = alpha >= 1.0;
  const double a = boost_mask ? alpha : alpha + 1.0;
  const double d = a - one_third;
  const double c = one_third / sqrt(d);
  uint2 k = threefry(key, 0u, 0u);
  const uint2 subkey = threefry(key, 0u, 1u);
  double X = 0.0, V = 1.0, U = 2.0;
  while ((U >= 1.0 - 0.0331 * (X * X)) &&
         (log(U) >= X * 0.5 + d * ((1.0 - V) + log(V)))) {
    uint2 x_key = threefry(k, 0u, 1u);
    const uint2 u_key = threefry(k, 0u, 2u);
    k = threefry(k, 0u, 0u);
    double x = 0.0, v = -1.0;
    while (v <= 0.0) {
      const uint2 sub = threefry(x_key, 0u, 1u);
      x_key = threefry(x_key, 0u, 0u);
      x = normal_from_words(threefry(sub, 0u, 0u));
      v = 1.0 + x * c;
    }
    X = x * x;
    V = (v * v) * v;
    U = uniform_at0(u_key);
  }
  const double u = uniform_at0(subkey);
  if (log_space) {
    const double log_samples = log1p(-u);
    const double log_boost =
        (boost_mask || log_samples == 0.0) ? 0.0 : log_samples * (1.0 / alpha);
    return (log(d) + log(V)) + log_boost;
  }
  // pow(1 - u, 1 / alpha) as exp(log(1 - u) * (1 / alpha)): the math
  // library's pow, compiled here under --fmad=false, rounds otherwise than
  // the pow torch's operators call (ops/prng.py says how far from XLA's).
  const double boost =
      boost_mask ? 1.0 : exp(log(1.0 - u) * (1.0 / alpha));
  return (d * V) * boost;
}

// keys: (n_keys, 2) int64; alpha and out: (n_keys, n) float64.
__global__ void draw_gamma_kernel(const long long* __restrict__ keys,
                                  long long n_keys,
                                  const double* __restrict__ alpha,
                                  long long n, int log_space,
                                  double* __restrict__ out) {
  const long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n_keys * n) return;
  const long long r = i / n, e = i - r * n;
  const uint2 key = threefry(
      make_uint2((uint32_t)keys[2 * r], (uint32_t)keys[2 * r + 1]),
      (uint32_t)((uint64_t)e >> 32), (uint32_t)e);
  out[i] = gamma_one(key, alpha[i], log_space != 0);
}

}  // namespace

extern "C" {

int canopy_prng_draw_standard(const void* rows, const void* params,
                              int n_rows, long long n_trials, int ld,
                              void* out, void* stream) {
  const long long t_blocks = (n_trials + TILE - 1) / TILE;
  const long long r_blocks = (n_rows + TILE - 1) / TILE;
  if (t_blocks > 0x7FFFFFFFLL || r_blocks > 65535)
    return (int)cudaErrorInvalidConfiguration;
  draw_standard_kernel<<<dim3((unsigned)t_blocks, (unsigned)r_blocks),
                         32 * WARPS, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const long long*>(rows), static_cast<const double*>(params),
      n_rows, n_trials, ld, static_cast<double*>(out));
  return (int)cudaGetLastError();
}

int canopy_prng_draw_gamma(const void* keys, long long n_keys,
                           const void* alpha, long long n, int log_space,
                           void* out, void* stream) {
  constexpr int THREADS = 128;
  const long long blocks = (n_keys * n + THREADS - 1) / THREADS;
  if (blocks > 0x7FFFFFFFLL) return (int)cudaErrorInvalidConfiguration;
  draw_gamma_kernel<<<(unsigned)blocks, THREADS, 0,
                      static_cast<cudaStream_t>(stream)>>>(
      static_cast<const long long*>(keys), n_keys,
      static_cast<const double*>(alpha), n, log_space,
      static_cast<double*>(out));
  return (int)cudaGetLastError();
}

}  // extern "C"
