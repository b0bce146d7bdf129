// Stream-program forward kernels: the step kernel and the
// one-trial-per-thread kernel (trial-parallel), and the level-parallel
// logged forward.
//
// Replaces canopy_tpu/ops/stream_kernel.py:_stream_kernel (the VMEM-pool
// stream kernel) and, with the log on, canopy_tpu/ops/adjoint_kernel.py:
// _tape_kernel (the taped forward).
//
// Trial-parallel stream (uncertainty: 2^20 trials of one program).  What
// bounds it on an H100 is latency and issue, not bytes (the BDD slice's
// module needs 0.656 ms of operations): every op is a short chain (read
// its arguments, four multiplies and adds, write its value) and in
// depth-first order the next op usually reads that value.  The first
// design (stream_ops_kernel below) runs one trial per thread and one op
// at a time over the general op table, the pool (pool_slots, T) in
// device memory; it stays for programs of products, pairs and counts
// (tree programs), whose long eval_op chains need the occupancy of its
// 32 registers.  Programs of muxes (every BDD program) run
// stream_steps_kernel:
//   * ops are packed int4 records (ops/stream_kernel.pack_records): a
//     mux over a staged decision variable and two pool rows is one record
//     {kind | out, p row, hi slot, lo slot}; any other op names its row of
//     the general table and runs eval_op.  The block stages records into
//     a double-buffered shared-memory ring with cp.async, so each decode
//     is a broadcast shared-memory read;
//   * muxes run in steps of 8 / K that read no value of their own step
//     (BDD programs are scheduled so: compile_bdd_stream(batch=8)), the
//     whole step loaded before any of it is stored, so a thread keeps 8
//     mux chains in flight where one op at a time kept one;
//   * each thread runs K trials (kTrials: 2 in float32, the fastest of
//     K = 1, 2, 4 on the card; 1 in float64): one decode drives K
//     independent loads and multiplies; its trials are base + k * B + i,
//     so every row access coalesces;
//   * each mux's staged read is issued kPrefetch steps ahead into
//     registers, so its latency overlaps the steps between;
//   * the pool is (pool_slots + 1, Tp) in device memory.  A pool in
//     shared memory measured slower on the BDD slice's module (PERF.md):
//     it caps the SM at about 320 resident trials, while the device-memory
//     pool keeps four to five times the warps resident and its rows still
//     hit L1.
//
// Every root of a multi-root program at once (event-tree sequences:
// 2^20 trials of all 64 roots, f64).  stream_ops_kernel copies n_out pool
// slots (out_slots) into an (n_out, T) output; a single-top program is
// the case n_out = 1.  It replaces no Pallas kernel: the JAX package
// evaluates sequences with XLA's gather engine
// (canopy_tpu/engine/analysis.py:835-842), a (nodes, trials) matrix
// rewritten level by level.  The bound is bytes: the staged basic events
// read once and the roots written once, (264 + 64) x 8 B a trial on the
// plant tree, 0.82 ms at 2^20 trials (its 2,173 f64 operations a trial
// take 0.07 ms).  The pool is the traffic beyond that bound, so it is
// kept to the live set: the roots share one depth-first order and one
// linear scan (ops/stream_kernel.compile_tree_stream), each shared gate
// runs once, a slot is reused as soon as its value's last reader has
// run, and a root's slot is held to the end (76 rows for the plant
// tree's 777 gates, against the gather engine's 1,041 a trial), so a
// value is read soon after it is written.
//
// Level-parallel logged forward (importance: one trial, f64).  One thread
// walking 10,483 ops in series is a chain of dependent loads; here the
// block takes the ops of one level (ops/stream_kernel.level_schedule) in
// parallel, a barrier between levels, each value going straight to the
// log (in shared memory when the tile's log fits, else device memory).
// Arguments are read by their backward source (the log row of the op
// that wrote them, or their staged row), so the pool has no part in it.
//
// Built with --fmad=false: every multiply and add rounds on its own, in
// the plain PyTorch version's order (eval_op), so kernel and plain agree
// bit for bit whatever order the ops run in.  The value type is a
// template parameter: float32 for uncertainty batches, float64 where
// precision matters more than bytes (importance's single trial, whose mux
// partials cancel in f32).
#include "stream_ops.cuh"

using namespace canopy;

namespace {

// Records per staged chunk (ops/stream_kernel.py REC_CHUNK).
constexpr int REC_CHUNK = 128;
// Threads per block of the step kernel; a block runs STEP_THREADS *
// kTrials<V> trials (ops/stream_kernel.py _STEP_TRIALS).
constexpr int STEP_THREADS = 128;
enum RecKind { R_NOP = 0, R_MUX = 1, R_OP = 2 };
// Trials per thread: 2 in float32 (the card's K sweep, PERF.md), 1 in
// float64 (not swept).
template <typename V>
constexpr int kTrials = sizeof(V) == 4 ? 2 : 1;
// Steps of prefetch: each mux's staged read is issued this many steps
// (of kStep<V> records) before its use: 8 values per step per thread, so
// 32 registers of float32 at 4 steps, 32 of float64 at 2.
template <typename V>
constexpr int kPrefetch = sizeof(V) == 4 ? 4 : 2;
// Records per step: a step of muxes is independent (no mux reads another
// of its step), so its loads all issue before any of its stores; with K
// trials per thread a step keeps 8 mux chains in flight per thread.
template <typename V>
constexpr int kStep = 8 / kTrials<V>;

__device__ __forceinline__ void cp_async16(void* dst, const void* src) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(s),
               "l"(src));
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}
__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.wait_all;\n" ::: "memory");
}

// recs: steps of kStep<V> records, whole chunks, then one chunk of NOPs
// (read only by the prefetch).  A step is either muxes, padded with
// muxes into the scratch row pool_slots (no branch in the step), or
// general ops (R_OP, op rec_op[rec]; padded with NOPs), run one by one.
// rec_op: the op of each record, -1 for padding.  gpool: (pool_slots + 1,
// Tp) in device memory, Tp a multiple of the block's trials.  T and Tp
// are below 2^31 (the launcher checks), so a row offset is one 32 x 32 ->
// 64-bit multiply.  The launch bound keeps the register budget of two
// 256-thread blocks per SM (128 registers), as the kernel was measured.
template <typename V>
__global__ void __launch_bounds__(2 * STEP_THREADS, 2)
    stream_steps_kernel(const int4* __restrict__ recs,
                        const int* __restrict__ rec_op, int n_chunks,
                        const int* __restrict__ ops,
                        const float* __restrict__ fill,
                        const int* __restrict__ args,
                        const V* __restrict__ staged,
                        const V* __restrict__ house, V* gpool, long long Tp,
                        V* __restrict__ top, long long T, int top_slot) {
  constexpr int K = kTrials<V>;
  constexpr int U = kStep<V>;
  constexpr int P = kPrefetch<V>;
  constexpr int D = U * P;
  constexpr int B = STEP_THREADS;
  static_assert(REC_CHUNK % D == 0, "prefetch window must divide a chunk");
  __shared__ __align__(16) int4 ring[2 * REC_CHUNK];
  const int i = threadIdx.x;
  const long long base = (long long)blockIdx.x * (B * K);
  // Trial k of this thread is base + k * B + i; the last block's trials
  // beyond T compute on zeros and store nothing.  Row r of the staged
  // input for trial k is sb[r * T + k * B]; of the pool gb[r * Tp + k * B]
  // (Tp >= the grid's trials, so no trial is masked).
  const int valid = (int)(T - base < B * K ? T - base : B * K);
  const int Ti = (int)T, Tpi = (int)Tp;
  const V* sb = staged + base + i;
  V* gb = gpool + base + i;
  auto stage = [&](int c, int buf) {
    const int4* src = recs + (long long)c * REC_CHUNK;
    int4* dst = ring + buf * REC_CHUNK;
    for (int j = i; j < REC_CHUNK; j += B) cp_async16(dst + j, src + j);
    cp_async_commit();
  };
  // The staged value of a record's p row (field y): read for every
  // record, a general op's or a NOP's y being row 0, so no branch.
  auto prefetch = [&](const int4* rec, V (&p)[K]) {
    const V* at_row =
        sb + (long long)reinterpret_cast<const int2*>(rec)->y * Ti;
#pragma unroll
    for (int k = 0; k < K; ++k)
      p[k] = k * B + i < valid ? at_row[k * B] : V(0);
  };
  auto row_of = [&](int slot) { return gb + (long long)slot * Tpi; };
  auto load_row = [&](int slot, V (&v)[K]) {
    const V* r = row_of(slot);
#pragma unroll
    for (int k = 0; k < K; ++k) v[k] = r[k * B];
  };
  auto store_row = [&](int slot, const V (&v)[K]) {
    V* r = row_of(slot);
#pragma unroll
    for (int k = 0; k < K; ++k) r[k * B] = v[k];
  };

  V pf[P][U][K];
  stage(0, 0);
  cp_async_wait_all();
  __syncthreads();
#pragma unroll
  for (int s = 0; s < P; ++s)
#pragma unroll
    for (int u = 0; u < U; ++u) prefetch(ring + s * U + u, pf[s][u]);
  stage(1, 1);
  for (int c = 0; c < n_chunks; ++c) {
    const int4* cur = ring + (c & 1) * REC_CHUNK;
    const int4* nxt = ring + ((c + 1) & 1) * REC_CHUNK;
    for (int j = 0; j < REC_CHUNK; j += D) {
      if (j == REC_CHUNK - D) {  // the prefetch now reads chunk c + 1
        cp_async_wait_all();
        __syncthreads();
      }
#pragma unroll
      for (int s = 0; s < P; ++s) {
        const int first = j + s * U;
        V p[U][K];
#pragma unroll
        for (int u = 0; u < U; ++u) {
#pragma unroll
          for (int k = 0; k < K; ++k) p[u][k] = pf[s][u][k];
          const int ahead = first + u + D;
          prefetch(ahead < REC_CHUNK ? cur + ahead : nxt + ahead - REC_CHUNK,
                   pf[s][u]);
        }
        if (((unsigned)cur[first].x >> 24) == R_MUX) {
          // A step of independent muxes: every load, then every store.
          V hi[U][K], lo[U][K];
#pragma unroll
          for (int u = 0; u < U; ++u) {
            const int4 r = cur[first + u];
            load_row(r.z, hi[u]);
            load_row(r.w, lo[u]);
          }
#pragma unroll
          for (int u = 0; u < U; ++u) {
            V v[K];
#pragma unroll
            for (int k = 0; k < K; ++k)
              v[k] = p[u][k] * hi[u][k] + (V(1) - p[u][k]) * lo[u][k];
            store_row(cur[first + u].x & 0xFFFFFF, v);
          }
        } else {
#pragma unroll 1
          for (int u = 0; u < U; ++u) {
            const int4 r = cur[first + u];
            if (((unsigned)r.x >> 24) != R_OP) continue;
            const int o = rec_op[(long long)c * REC_CHUNK + first + u];
            const int out = r.x & 0xFFFFFF;
            const int* op = ops + (long long)o * OP_COLS;
#pragma unroll 1
            for (int k = 0; k < K; ++k) {
              const long long tk = base + k * B + i;
              const long long t = tk < T ? tk : T - 1;  // staged reads
              const GlobalRows<V> rows{gpool, Tp, tk};
              // Step programs hold muxes and fills only: no count DP.
              gpool[at(out, Tp, tk)] = eval_op(op, o, fill, args, staged,
                                               house, rows, T, t,
                                               DpScratch<V>{nullptr, 0});
            }
          }
        }
      }
    }
    __syncthreads();  // every thread is done with buffer c & 1
    if (c + 2 <= n_chunks) stage(c + 2, c & 1);
  }
#pragma unroll
  for (int k = 0; k < K; ++k) {
    if (k * B + i < valid) top[base + k * B + i] = row_of(top_slot)[k * B];
  }
}

template <typename V>
int launch_steps(const int4* recs, const int* rec_op, int n_chunks,
                 const int* ops, const float* fill, const int* args,
                 const V* staged, const V* house, V* gpool, long long Tp,
                 V* top, long long T, int top_slot, void* stream) {
  constexpr int W = STEP_THREADS * kTrials<V>;
  if (T <= 0 || T >= (1LL << 31) || Tp >= (1LL << 31) || Tp < T ||
      Tp % W != 0)
    return (int)cudaErrorInvalidValue;
  const long long blocks = (T + W - 1) / W;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  stream_steps_kernel<V><<<(unsigned)blocks, STEP_THREADS, 0, s>>>(
      recs, rec_op, n_chunks, ops, fill, args, staged, house, gpool, Tp, top,
      T, top_slot);
  return (int)cudaGetLastError();
}

// One trial per thread over the general op table, the pool (pool_slots,
// T) in device memory: the first design, kept for programs of general
// ops (tree programs), whose eval_op chains need the occupancy of a small
// register footprint.  At the end each thread copies the pool slots
// out_slots[0 .. n_out) of its trial into rows of out (n_out, T): the
// top alone, or every root of a multi-root program.  Blocks of
// OPS_THREADS (ops/stream_kernel.py _OPS_THREADS, which sizes the
// count-DP scratch).
constexpr int OPS_THREADS = 128;

template <typename V>
__global__ void stream_ops_kernel(const int* __restrict__ ops,
                                  const float* __restrict__ fill,
                                  const int* __restrict__ args, int n_ops,
                                  const V* __restrict__ staged,
                                  const V* __restrict__ house, V* pool,
                                  V* __restrict__ out, long long T,
                                  const int* __restrict__ out_slots,
                                  int n_out, V* dp_base) {
  const long long t = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (t >= T) return;
  const GlobalRows<V> rows{pool, T, t};
  const DpScratch<V> dp = dp_scratch(dp_base);
  for (int o = 0; o < n_ops; ++o) {
    const int* op = ops + (long long)o * OP_COLS;
    pool[at(op[1], T, t)] =
        eval_op(op, o, fill, args, staged, house, rows, T, t, dp);
  }
  for (int k = 0; k < n_out; ++k)
    out[at(k, T, t)] = pool[at(out_slots[k], T, t)];
}

template <typename V>
int launch_ops(const int* ops, const float* fill, const int* args, int n_ops,
               const V* staged, const V* house, V* pool, V* out, long long T,
               const int* out_slots, int n_out, V* dp, void* stream) {
  const int threads = OPS_THREADS;
  const long long blocks = (T + threads - 1) / threads;
  stream_ops_kernel<V><<<(unsigned)blocks, threads, 0,
                         static_cast<cudaStream_t>(stream)>>>(
      ops, fill, args, n_ops, staged, house, pool, out, T, out_slots, n_out,
      dp);
  return (int)cudaGetLastError();
}

// Level-parallel logged forward: block b runs trials [b * tile, ...) and
// walks the levels in order, its threads sharing each level's (op,
// trial) items.  SMEM_LOG: the tile's log is a (n_log, tile) array in
// shared memory, copied out at the end; else the log in device memory.
template <typename V, bool SMEM_LOG>
__global__ void stream_level_forward_kernel(
    const int* __restrict__ ops, const float* __restrict__ fill,
    const int* __restrict__ args, const int* __restrict__ order,
    const int* __restrict__ level_ptr, int n_levels,
    const V* __restrict__ staged, const V* __restrict__ house, V* log,
    V* __restrict__ top, long long T, int tile, int n_log, int top_src,
    int top_idx, V* dp_base) {
  extern __shared__ __align__(16) unsigned char smem[];
  V* slog = reinterpret_cast<V*>(smem);
  const DpScratch<V> dp = dp_scratch(dp_base);
  const long long t0 = (long long)blockIdx.x * tile;
  const int nt = (int)(T - t0 < tile ? T - t0 : tile);
  V* rows = SMEM_LOG ? slog : log;
  const long long stride = SMEM_LOG ? tile : T;
  for (int L = 0; L < n_levels; ++L) {
    const int first = level_ptr[L], m = level_ptr[L + 1] - first;
    for (int item = threadIdx.x; item < m * nt; item += blockDim.x) {
      const int o = order[first + item / nt], tl = item % nt;
      const long long t = t0 + tl;
      const int* op = ops + (long long)o * OP_COLS;
      const int row = op[6];
      if (row < 0) continue;  // SPILL: its readers read the staged row
      const long long c = SMEM_LOG ? tl : t;
      const BackReads<V> x{args, staged, house, rows, stride, c, T, t};
      rows[(long long)row * stride + c] =
          eval_op_with(op, V(fill[o]), x, dp);
    }
    __syncthreads();
  }
  if (SMEM_LOG) {
    for (int item = threadIdx.x; item < n_log * nt; item += blockDim.x) {
      const int row = item / nt, tl = item % nt;
      log[at(row, T, t0 + tl)] = slog[(long long)row * tile + tl];
    }
  }
  for (int tl = threadIdx.x; tl < nt; tl += blockDim.x) {
    const long long t = t0 + tl;
    top[t] = top_src == LOG
                 ? rows[(long long)top_idx * stride + (SMEM_LOG ? tl : t)]
                 : staged[at(top_idx, T, t)];
  }
}

constexpr int LEVEL_THREADS = 256;

template <typename V>
int launch_level_forward(const int* ops, const float* fill, const int* args,
                         const int* order, const int* level_ptr, int n_levels,
                         const V* staged, const V* house, V* log, V* top,
                         long long T, int tile, int n_log, int top_src,
                         int top_idx, int smem_log, V* dp, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const long long blocks = (T + tile - 1) / tile;
  if (smem_log) {
    const size_t smem = (size_t)n_log * tile * sizeof(V);
    auto kernel = stream_level_forward_kernel<V, true>;
    cudaError_t err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return (int)err;
    kernel<<<(unsigned)blocks, LEVEL_THREADS, smem, s>>>(
        ops, fill, args, order, level_ptr, n_levels, staged, house, log, top,
        T, tile, n_log, top_src, top_idx, dp);
  } else {
    stream_level_forward_kernel<V, false>
        <<<(unsigned)blocks, LEVEL_THREADS, 0, s>>>(
            ops, fill, args, order, level_ptr, n_levels, staged, house, log,
            top, T, tile, n_log, top_src, top_idx, dp);
  }
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

// The step kernel: top (T,); gpool (pool_slots + 1, Tp) scratch, the
// last row for the padding muxes, Tp a multiple of the block's trials.
int canopy_stream_forward_f32(const void* recs, const int* rec_op,
                              int n_chunks, const int* ops, const float* fill,
                              const int* args, const float* staged,
                              const float* house, float* gpool, long long Tp,
                              float* top, long long T, int top_slot,
                              void* stream) {
  return launch_steps<float>(static_cast<const int4*>(recs), rec_op,
                             n_chunks, ops, fill, args, staged, house, gpool,
                             Tp, top, T, top_slot, stream);
}

int canopy_stream_forward_f64(const void* recs, const int* rec_op,
                              int n_chunks, const int* ops, const float* fill,
                              const int* args, const double* staged,
                              const double* house, double* gpool,
                              long long Tp, double* top, long long T,
                              int top_slot, void* stream) {
  return launch_steps<double>(static_cast<const int4*>(recs), rec_op,
                              n_chunks, ops, fill, args, staged, house,
                              gpool, Tp, top, T, top_slot, stream);
}

// The one-trial-per-thread kernel: out (n_out, T), row k the pool slot
// out_slots[k] (int32, on the card); pool (pool_slots, T) scratch; dp the
// count-DP scratch (states, blocks * OPS_THREADS) or null (dp_scratch,
// stream_ops.cuh).
int canopy_stream_ops_forward_f32(const int* ops, const float* fill,
                                  const int* args, int n_ops,
                                  const float* staged, const float* house,
                                  float* pool, float* out, long long T,
                                  const int* out_slots, int n_out, float* dp,
                                  void* stream) {
  return launch_ops<float>(ops, fill, args, n_ops, staged, house, pool, out,
                           T, out_slots, n_out, dp, stream);
}

int canopy_stream_ops_forward_f64(const int* ops, const float* fill,
                                  const int* args, int n_ops,
                                  const double* staged, const double* house,
                                  double* pool, double* out, long long T,
                                  const int* out_slots, int n_out,
                                  double* dp, void* stream) {
  return launch_ops<double>(ops, fill, args, n_ops, staged, house, pool, out,
                            T, out_slots, n_out, dp, stream);
}

// log (n_log, T), top (T,); order/level_ptr from level_schedule; dp the
// count-DP scratch (states, blocks * LEVEL_THREADS) or null.
int canopy_stream_level_forward_f32(const int* ops, const float* fill,
                                    const int* args, const int* order,
                                    const int* level_ptr, int n_levels,
                                    const float* staged, const float* house,
                                    float* log, float* top, long long T,
                                    int tile, int n_log, int top_src,
                                    int top_idx, int smem_log, float* dp,
                                    void* stream) {
  return launch_level_forward<float>(ops, fill, args, order, level_ptr,
                                     n_levels, staged, house, log, top, T,
                                     tile, n_log, top_src, top_idx, smem_log,
                                     dp, stream);
}

int canopy_stream_level_forward_f64(const int* ops, const float* fill,
                                    const int* args, const int* order,
                                    const int* level_ptr, int n_levels,
                                    const double* staged,
                                    const double* house, double* log,
                                    double* top, long long T, int tile,
                                    int n_log, int top_src, int top_idx,
                                    int smem_log, double* dp, void* stream) {
  return launch_level_forward<double>(ops, fill, args, order, level_ptr,
                                      n_levels, staged, house, log, top, T,
                                      tile, n_log, top_src, top_idx,
                                      smem_log, dp, stream);
}

const char* canopy_cuda_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

int canopy_max_count_states() { return MAX_COUNT_STATES; }

int canopy_stream_rec_chunk() { return REC_CHUNK; }


}  // extern "C"
